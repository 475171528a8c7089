"""Multi-pod dry-run: count every (arch × shape × mesh) cell of one rank.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell on 512 placeholder CPU devices; here this process is one rank
(``--rank``, 0 by default) of a fake process group of the production
mesh's 256 (``single``: 16×16) or 512 (``multi``: 2×16×16) ranks, whose
collectives move nothing, and the rank's program is traced on fake
tensors on ``--device`` (:mod:`repro_torch.launch.cells`).  Nothing is
allocated; the record says what one card of the mesh would run.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b \\
        --shape train_4k --mesh single --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi

``--device`` is ``cuda`` by default, as every entry point of the port;
without a card it raises, naming ``--device cpu``, before it traces
anything (a fake CUDA tensor aborts a CPU-only build of torch).  Each
cell writes ``{arch}__{shape}__{mesh_kind}.json`` under ``--out``
(``build/dryrun`` by default): the record of
:func:`repro_torch.launch.cells.analyze` with ``status``, ``mesh_kind``,
``lower_s`` (the traces' seconds) and the traced depths.  The fake group
must be the process's only process group.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Optional


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: Optional[str], device="cuda", mesh=None) -> dict:
    """Count one (arch, shape, mesh) cell and write its JSON record under
    ``out_dir`` (``None``: write nothing).  ``mesh`` is the rank's
    ``LiveMesh`` on the production mesh's fake group (:func:`main` makes
    it; ``cells.dry_group``)."""
    from repro_torch.configs import SHAPES, cell_supported, get_config
    from repro_torch.launch import cells
    from repro_torch.training import TrainConfig

    cells.check_device(device)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "skipped", "reason": why}
        _write(out_dir, rec)
        return rec
    t0 = time.time()
    # The reference's baseline train step: 8 microbatches.
    lowered = cells.lower_cell(cfg, shape, mesh,
                               TrainConfig(microbatches=8), device=device)
    rec = cells.analyze(lowered, cfg, shape, mesh)
    rec.update({"status": "ok", "mesh_kind": mesh_kind,
                "lower_s": round(time.time() - t0, 2)})
    _write(out_dir, rec)
    return rec


def _write(out_dir: Optional[str], rec: dict) -> None:
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    name = (f"{rec['arch']}__{rec['shape']}__"
            f"{rec.get('mesh_kind', rec.get('mesh'))}.json")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None) -> int:
    """CLI entry: run one cell (``--arch/--shape``) or sweep ``--all``
    supported cells on the production mesh; 1 if any cell failed."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.join("build", "dryrun"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the production mesh to count")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda needs a CUDA device and "
                 "torch.cuda.is_available() is False; pass --device cpu "
                 "to trace on the CPU")
    from repro_torch.configs import ARCH_NAMES, SHAPES
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import production_mesh_spec

    todo = ([(a, s) for a in ARCH_NAMES for s in SHAPES] if args.all
            else [(args.arch, args.shape)])
    spec = production_mesh_spec(multi_pod=args.mesh == "multi")
    failures = 0
    with cells.dry_group(spec, args.rank, args.device) as live:
        for arch, shape in todo:
            tag = f"{arch} × {shape} × {args.mesh}"
            try:
                rec = run_cell(arch, shape, args.mesh, args.out,
                               device=args.device, mesh=live)
                status = rec["status"]
                extra = (f" bottleneck={rec.get('bottleneck')}"
                         f" rf={rec.get('roofline_fraction', 0):.3f}"
                         if status == "ok" else f" ({rec.get('reason')})")
                print(f"[dryrun] {tag}: {status}{extra}", flush=True)
            except Exception:
                failures += 1
                traceback.print_exc()
                print(f"[dryrun] {tag}: FAILED", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
