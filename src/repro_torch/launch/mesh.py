"""Production mesh builders, described as :class:`repro_torch.dist.MeshSpec`s.

The port of ``repro.launch.mesh``.  The specs are the same objects
``CompileOptions(mesh=...)`` and ``SchedulerOptions(mesh=...)`` take, so
the launch scripts, the serve CLI and the compiler speak one mesh
spelling.  A live mesh is one process a device in a
``torch.distributed`` group: the ``make_*`` shims bind a spec to the
default process group (:class:`~repro_torch.dist.collectives.LiveMesh`)
and raise :class:`~repro_torch.dist.MeshUnavailableError` naming the
unfillable axes when the group is too small.

The hardware constants are NVIDIA's H100 SXM data sheet (the card
``nvidia-smi`` reports as "NVIDIA H100 80GB HBM3" at a 700.00 W power
limit), for the roofline terms of the dry-run tools.
"""

from __future__ import annotations

from ..dist.mesh import MeshSpec, available_devices


def production_mesh_spec(*, multi_pod: bool = False) -> MeshSpec:
    """16×16 = 256 devices per pod; ``multi_pod`` stacks 2 pods -> 512.
    The "pod" axis composes with "data" for the batch dimension (pure DP
    across pods), so the only cross-pod collective is the gradient
    reduce."""
    if multi_pod:
        return MeshSpec(axes=(("pod", 2), ("data", 16), ("model", 16)))
    return MeshSpec(axes=(("data", 16), ("model", 16)))


def host_mesh_spec() -> MeshSpec:
    """The ranks of the default process group (1 without one) as a 1×N
    (data, model) mesh."""
    return MeshSpec(axes=(("data", 1), ("model", available_devices())))


def init_group(device: str) -> str:
    """Join the gloo process group ``torch.distributed.run`` describes in
    the environment (when it does; gloo, since ranks may share a card);
    this rank's device."""
    import os
    import torch
    import torch.distributed as dist
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return device
    dist.init_process_group("gloo", init_method="env://")
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        device = f"cuda:{local % torch.cuda.device_count()}"
    return device


def _live(spec: MeshSpec, device):
    import torch
    from ..dist.collectives import LiveMesh
    return LiveMesh(spec, torch.device(device))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The :class:`LiveMesh` of :func:`production_mesh_spec` on the
    default process group (back-compat shim: new code carries the spec
    and binds it at the last moment)."""
    return _live(production_mesh_spec(multi_pod=multi_pod), device)


def make_host_mesh(device="cuda"):
    """The :class:`LiveMesh` of :func:`host_mesh_spec`."""
    return _live(host_mesh_spec(), device)


# Data-sheet constants per card, for "NVIDIA H100 80GB HBM3" at a
# "700.00 W" power limit (nvidia-smi's name and limit).
#: NVIDIA H100 80GB HBM3, 700.00 W: dense bf16 tensor-core FLOP/s.
PEAK_FLOPS_BF16 = 989e12
#: NVIDIA H100 80GB HBM3, 700.00 W: HBM3 bytes/s.
HBM_BW = 3.35e12
#: NVIDIA H100 80GB HBM3, 700.00 W: NVLink 4 bytes/s each way (900 GB/s
#: both ways).
NVLINK_BW = 450e9
#: NVIDIA H100 80GB HBM3, 700.00 W: device memory, bytes.
CHIP_HBM_BYTES = 80 * 10 ** 9
