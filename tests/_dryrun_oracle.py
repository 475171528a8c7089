"""Shared pieces of the dry-run's CPU tests.

The reference's FLOPs of the SMOKE cells come from its own
``repro.launch.cells.lower_cell`` and ``hlo_analysis.flops_from_pre``
(lowered, never compiled), run in a subprocess with 4 host devices on a
1-device mesh and on ``data=2,model=2``.  ``KEPT`` holds the port's
measured ratio to them where the two count more than 1% apart (ROADMAP
C, "The dry-run's FLOPs"); a test holds such a cell to its ratio within
0.5% and every other cell to 1%.
"""

import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The cells' shape: sequence, global batch; train cells' microbatches.
SEQ, BATCH, MICROBATCHES = 64, 8, 2
#: mesh (chips) -> its axes, for both packages.
MESHES = {1: (("data", 1), ("model", 1)), 4: (("data", 2), ("model", 2))}
LIMIT = 0.01
KEPT_LIMIT = 0.005

_TRAIN = {"qwen2.5-14b": 0.94608, "deepseek-7b": 0.94737,
          "gemma3-27b": 0.94149, "minicpm-2b": 0.95000,
          "deepseek-v3-671b": 0.93942, "mixtral-8x22b": 0.97804,
          "internvl2-2b": 0.94614, "recurrentgemma-9b": 0.98464,
          "whisper-base": 0.94149}
#: chips -> (arch, kind) -> the port's FLOPs over the reference's.
KEPT = {
    1: {**{(a, "train"): r for a, r in _TRAIN.items()},
        ("mamba2-780m", "decode"): 0.94586},
    # 4 chips: the port's count is 4 x rank 0's of the partitioned
    # program; the serving cells repeat what ROADMAP C keeps whole on
    # ``model`` (MLA's down projections and the router, mamba2's mixer,
    # recurrentgemma's one KV head)
    4: {**{(a, "train"): r for a, r in _TRAIN.items()},
        ("deepseek-v3-671b", "train"): 0.93256,
        ("mixtral-8x22b", "train"): 0.97610,
        ("deepseek-v3-671b", "prefill"): 1.06993,
        ("deepseek-v3-671b", "decode"): 1.05691,
        ("mamba2-780m", "prefill"): 1.98113,
        ("mamba2-780m", "decode"): 1.68790,
        ("recurrentgemma-9b", "prefill"): 1.01292,
        ("recurrentgemma-9b", "decode"): 1.01132},
}

_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    from repro.configs import ARCH_NAMES, ShapeSpec, get_config
    from repro.dist.mesh import MeshSpec
    from repro.launch import cells
    from repro.launch.hlo_analysis import flops_from_pre
    from repro.training import TrainConfig
    seq, batch, mb, meshes = json.loads(sys.argv[2])
    out = {}
    for chips, axes in meshes.items():
        mesh = MeshSpec(axes=tuple(tuple(a) for a in axes)).build()
        for arch in ARCH_NAMES:
            cfg = get_config(arch, smoke=True)
            for kind in sys.argv[3].split(","):
                lowered = cells.lower_cell(cfg, ShapeSpec("t", seq, batch,
                                                          kind), mesh,
                                           TrainConfig(microbatches=mb))
                flops, unresolved = flops_from_pre(
                    lowered.as_text("hlo"), int(chips))
                assert unresolved == 0, (arch, kind)
                out[f"{arch}|{kind}|{chips}"] = flops / int(chips)
    json.dump(out, open(sys.argv[1], "w"))
""")


def start_reference(path, kinds):
    """Start the reference's FLOPs of ``kinds`` (train, prefill, decode)
    for the ten SMOKE configs on both meshes, written to ``path``
    (per device, as its dry-run reports them); returns the process."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    args = json.dumps([SEQ, BATCH, MICROBATCHES,
                       {str(k): v for k, v in MESHES.items()}])
    return subprocess.Popen([sys.executable, "-c", _SCRIPT, str(path), args,
                             ",".join(kinds)], cwd=ROOT, env=env)


def reference(proc, path, timeout=300):
    """The reference's per-device FLOPs once ``proc`` has written them:
    ``{"arch|kind|chips": flops}``."""
    assert proc.wait(timeout=timeout) == 0
    with open(path) as f:
        return json.load(f)


def check_ratio(arch, kind, chips, port_global, ref_per_device):
    """The port's global FLOPs against the reference's per-device FLOPs
    times the chips: within 1%, or a kept divergence within 0.5% of its
    measured ratio."""
    ratio = port_global / (ref_per_device * chips)
    want = KEPT[chips].get((arch, kind))
    if want is None:
        assert abs(ratio - 1) <= LIMIT, (arch, kind, chips, ratio)
    else:
        assert abs(ratio - want) <= KEPT_LIMIT, (arch, kind, chips, ratio,
                                                 want)
