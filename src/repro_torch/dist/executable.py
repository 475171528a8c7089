"""ShardedExecutable — a JitExecutable whose mesh is a compile input.

The port of ``repro.dist.executable``.  Built by ``repro_torch.compile``
whenever ``CompileOptions(mesh=...)`` is set on the ``"jit"``/``"cuda"``
targets.  It rides the whole existing machinery — pass pipeline, kernel
selection, executable cache, capture bundles — and adds:

* the ``propagate_sharding`` pass input: ``graph.dist`` carries the mesh
  spec and rules in, and the resolved per-tensor specs and collective
  edit log out (the reference's, edit for edit);
* the run over a live mesh (more than one device: one process a device,
  the ranks of the default ``torch.distributed`` process group).  Every
  rank takes the global inputs; a batch that divides the batch axes is
  cut into rows, one part a rank, otherwise every rank runs all of it;
  each rank holds its slices of the weights (column-parallel denses
  their output channels, row-parallel ones their input channels, cut
  from the executable's own device params at construction); the dense
  rules and collectives move what the placement needs; the outputs are
  gathered back, so every rank returns the global outputs;
* a manifest in the executable cache grouping the executable's entries,
  so ``repro_torch.prune`` evicts a sharded executable as one unit.

Mesh and shardings are part of the cache key (``graph.dist`` in
``structure_hash``, ``mesh``/``sharding_rules`` in
``CompileOptions.cache_token``) and of the ``serialize()`` container: a
second process deserializing the artifact replays the placement with
zero re-propagation and hits the warm cache.

A program whose lowering talks to other ranks is not captured into a
CUDA graph unless the process group is NCCL's (gloo's collectives run on
the host): ``cost_summary()["sharding"]["captured"]`` says which.
"""

from __future__ import annotations

import io
import json
import os
import threading
from typing import Dict, Optional, Tuple

import torch

from ..api.cache import cache_key
from ..api.executable import pack
from ..api.targets import JitExecutable
from ..core.lowering import LoweringContext, quant_key
from ..frontends.container import save_model
from .collectives import LiveMesh, all_gather, communicates, local_part
from .mesh import MeshSpec, ensure_mesh_available
from .propagate import ShardingError, collective_summary


class ShardedExecutable(JitExecutable):
    """Mesh-aware compiled artifact: per-tensor partition specs, explicit
    collectives, and a device mesh bound at construction.

    A single-device mesh is bit-identical to the unsharded
    ``JitExecutable``: every collective is the identity and no weight is
    sliced.
    """

    def __init__(self, graph, options, *,
                 lowering_target: Optional[str] = None,
                 resolved: Optional[dict] = None) -> None:
        if options.mesh is None:
            raise ValueError("ShardedExecutable needs CompileOptions(mesh=...)")
        spec: MeshSpec = options.mesh
        # Fail before compiling, with the unfillable axes named.
        ensure_mesh_available(spec)
        self._mesh_spec = spec
        self._resolved = resolved
        self._tls = threading.local()
        self._live: Optional[LiveMesh] = None
        self._communicates = False
        annotated = graph.copy()
        annotated.dist = {"mesh": spec.to_dict(),
                          "rules": [list(p) for p in
                                    (options.sharding_rules or ())]}
        if resolved is not None:
            # Manifest round trip: replay the recorded placement instead
            # of propagating again (see dist.propagate._replay).
            annotated.dist["resolved"] = resolved
        super().__init__(annotated, options,
                         lowering_target=lowering_target
                         or ("cuda" if options.target == "cuda" else "jit"))
        if not spec.is_single_device:
            self._live = LiveMesh(spec, self.device)
            placement = LoweringContext(params={}, **self._lowering_extras())
            self._sliced = self._slice_params(placement)
            self._communicates = any(communicates(n, placement)
                                     for n in self.graph.nodes)

    # -- mesh ----------------------------------------------------------
    @property
    def mesh_spec(self) -> MeshSpec:
        """The static mesh description this executable was compiled for."""
        return self._mesh_spec

    @property
    def mesh(self):
        """The live ``torch.distributed.device_mesh.DeviceMesh``; None for
        a single-device mesh, which needs none."""
        return None if self._live is None else self._live.device_mesh

    def partition_spec(self, name: str) -> tuple:
        """The resolved (batch-inclusive) partition spec of a graph
        tensor, or of a public output name, as a tuple: per dim None, a
        mesh axis name, or a tuple of names."""
        shardings = self.graph.dist["shardings"]
        if name not in shardings:
            public = dict(zip(self.source.output_names, self.graph.outputs))
            if name in public:
                name = public[name]
        entry = shardings.get(name)
        if entry is None:
            raise KeyError(f"no resolved sharding for tensor {name!r}; "
                           f"known: {sorted(shardings)[:8]}...")
        return tuple(None if not axes else (axes[0] if len(axes) == 1
                                            else tuple(axes))
                     for axes in entry)

    # -- the placement on this rank ------------------------------------
    def _slice_params(self, placement) -> Dict[str, Tuple[int, ...]]:
        """Cut this rank's slices out of ``self.params`` in place: a
        column-parallel dense's kernel (and int8/bf16 operands) along its
        output channels with its bias, post-affine and dequant vectors; a
        row-parallel dense's along its input channels (bias and epilogue
        stay whole: they apply once, after the reduce); the per-channel
        params of any other node whose output channels are split.
        ``placement`` is a lowering context on the live mesh.  Returns
        the new shapes by param name."""
        live, done = self._live, {}

        def take(name: str, dim: int, k: int, i: int) -> None:
            if name in done:
                if done[name] != (dim, k, i):
                    raise ShardingError(
                        f"param {name!r} is read under two placements")
                return
            done[name] = (dim, k, i)
            self.params[name] = local_part(self.params[name], k, i,
                                           dim).contiguous()

        specs = self.graph.infer_shapes()
        for node in self.graph.nodes:
            row = placement.split_axes(node.inputs[0]) \
                if node.op == "dense" else ()
            col = placement.split_axes(node.output)
            pa = list(node.epilogue_attrs.get("post_affine") or [])
            if node.op == "dense" and (row or col):
                layout = node.attrs.get("kernel_layout", "io")
                k, i = live.split(row or col)
                wdim = (layout == "oi") if row else (layout == "io")
                for name in [node.params["kernel"]] + [
                        quant_key(node, q) for q in ("wq", "w")]:
                    if name in self.params:
                        take(name, int(wdim), k, i)
                if col:
                    for name in [node.params.get("bias"),
                                 quant_key(node, "deq"), *pa]:
                        if name in self.params:
                            take(name, 0, k, i)
            elif col:
                k, i = live.split(col)
                width = specs[node.output].shape[-1]
                for name in [*node.params.values(), *pa]:
                    if self.params[name].shape[-1:] != (width,):
                        raise ShardingError(
                            f"node {node.name!r} ({node.op}): param "
                            f"{name!r} of shape "
                            f"{tuple(self.params[name].shape)} does not "
                            f"follow its {width} split channels")
                    take(name, -1, k, i)
        return {n: tuple(self.params[n].shape) for n in done}

    def _lowering_extras(self) -> dict:
        live = self._live
        return {"mesh": live,
                "shardings": self.graph.dist.get("shardings", {}),
                "mesh_axis_sizes": dict(self._mesh_spec.axes),
                "coords": (dict(live.coords) if live is not None
                           else {a: 0 for a in self._mesh_spec.names})}

    @property
    def captures(self) -> bool:
        """True when the programs are captured CUDA graphs: on a CUDA
        device, unless the program talks to other ranks over a backend
        whose collectives a graph cannot record (gloo)."""
        return self.device.type == "cuda" and (
            not self._communicates or self._live.backend == "nccl")

    def _data_split(self, batch: int):
        """(parts, this rank's part, axes) of a batch cut into rows over
        the batch axes; (1, 0, ()) when the batch does not divide them
        (every rank runs all of it) or nothing splits it."""
        if self._live is None or not self.graph.inputs:
            return 1, 0, ()
        first = next(iter(self.graph.inputs))
        entry = self.graph.dist["shardings"].get(first) or [None]
        axes = self._live.canonical(entry[0] or ())
        k, i = self._live.split(axes)
        if k > 1 and batch % k == 0:
            return k, i, axes
        return 1, 0, ()

    # -- compilation and execution -------------------------------------
    def ensure_compiled(self, batch_size: int = 1):
        """The program of the rows this rank runs for a global batch of
        ``batch_size`` (its part when the batch divides the batch axes,
        else all of it); recorded in the cache manifest."""
        k = self._data_split(batch_size)[0]
        local = batch_size // k
        prog = super().ensure_compiled(local)
        self._record_manifest(local)
        return prog

    def _run(self, prog, args, bucket: int):
        """Run a global batch (``bucket`` rows, ``args`` up to that):
        this rank's rows through its program, the outputs gathered over
        the batch axes."""
        if getattr(self._tls, "local", False):
            return super()._run(prog, args, bucket)
        k, i, axes = self._data_split(bucket)
        if k == 1:
            return super()._run(prog, args, bucket)
        batch = args[0].shape[0]
        if batch != bucket:
            args = [torch.cat([a, a.new_zeros((bucket - batch,)
                                              + a.shape[1:])]) for a in args]
        n = bucket // k
        out = super()._run(prog, [a[i * n:(i + 1) * n] for a in args], n)
        out = {name: all_gather(v, axes, self._live, dim=0)
               for name, v in out.items()}
        if batch != bucket:
            out = {name: v[:batch] for name, v in out.items()}
        return out

    def _record(self, *args) -> None:
        # A bundle records the local program on its own seeded rows.
        self._tls.local = True
        try:
            super()._record(*args)
        finally:
            self._tls.local = False

    def __call__(self, *pos, **inputs):
        # The typed fault before every call: the group may have shrunk.
        ensure_mesh_available(self._mesh_spec)
        return super().__call__(*pos, **inputs)

    # -- the executable cache ------------------------------------------
    def _source_key(self) -> str:
        # A replayed placement is the one its compile derived, so the
        # recorded edits stay out of the key: a deserialized executable
        # finds the entries of the compile that serialized it.
        if self._graph_key is None:
            resolved = self._decided.dist.pop("resolved", None)
            try:
                super()._source_key()
            finally:
                if resolved is not None:
                    self._decided.dist["resolved"] = resolved
        return self._graph_key

    def manifest_key(self) -> str:
        """Identity of this executable's cache-manifest group (its graph
        entry and every batch size's program entry)."""
        return cache_key(self.device, "shard-manifest", self._source_key())

    def _record_manifest(self, batch_size: int) -> None:
        """Add this batch size's program entry (and the graph entry) to
        the on-disk manifest, so ``repro_torch.prune`` treats them and the
        manifest as one LRU unit (best effort, like the cache itself)."""
        if self._disk is None:
            return
        path = os.path.join(self._disk.root,
                            f"{self.manifest_key()}.manifest.json")
        keys = [self._source_key(), self._program_key(
            batch_size, self._selections.get(batch_size) or {})]
        try:
            doc = {"mesh": self._mesh_spec.to_dict(), "members": []}
            if os.path.exists(path):
                with open(path) as f:
                    doc = json.load(f)
            if all(k in doc["members"] for k in keys):
                return
            doc["members"] += [k for k in keys if k not in doc["members"]]
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except (OSError, ValueError, KeyError):
            pass

    # -- introspection / serialization ---------------------------------
    def cost_summary(self):
        """Compile-time facts plus a ``"sharding"`` block: the mesh, its
        device count, the reference's per-axis collective counts and
        bytes-moved estimates, the tensors with resolved specs, and this
        rank's side: its coordinates, backend, sliced params, whether its
        programs are captured CUDA graphs and whether its collectives go
        through the host, and whether the placement was replayed from a
        serialized artifact."""
        out = super().cost_summary()
        live = self._live
        out["sharding"] = {
            "mesh": self._mesh_spec.describe(),
            "devices": self._mesh_spec.size,
            "collectives": collective_summary(self.graph, self._mesh_spec),
            "tensors": len(self.graph.dist.get("shardings", {})),
            "coords": self._lowering_extras()["coords"],
            "backend": None if live is None else live.backend,
            "sliced_params": ({} if live is None
                              else {k: list(v)
                                    for k, v in self._sliced.items()}),
            "communicates": self._communicates,
            "captured": self.captures,
            "staged_through_host": live is not None and live.staged,
            "reused": self._resolved is not None,
        }
        return out

    def serialize(self) -> bytes:
        """Artifact container of kind ``"sharded"``: the source graph plus
        the resolved placement (specs and collective edit log), so
        ``repro_torch.deserialize`` rebuilds it with zero
        re-propagation."""
        buf = io.BytesIO()
        save_model(self.source, buf)
        dist = self.graph.dist
        return pack("sharded", self.options, buf.getvalue(),
                    extra={"signature": self.signature.to_dict(),
                           "dist": {"shardings": dist["shardings"],
                                    "edits": dist["edits"]}})
