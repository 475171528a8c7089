"""Run one cell of the benchmark once and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``'s
``workloads``; its configuration, traffic mix, limits and metrics are
files under ``bench/`` found by their names (see ``bench/__init__.py``).
With ``--trace 0`` the result carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from one profiler trace of
a slice at the end of the window, and a ``breakdown``.

The last line of standard output is the result, one JSON object; the
numbers the correctness check compared, each beside its limit, close
standard error and close the result (``check``).  Exit codes: 3, no
result, where the cell's cards are not all visible; 4, no result, where
the process has loaded JAX or the JAX package; any failure raises.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import ModuleType  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import load_module  # noqa: E402


@dataclasses.dataclass
class Run:
    """Everything a system module needs for one run of one cell."""
    cell: str
    config: Dict
    mix: Dict
    limits: Dict
    reference: ModuleType
    seed: int
    seconds: float
    trace: bool
    t0: float
    out_dir: Path
    device: str = "cuda"
    control: bool = False
    here: Path = HERE


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def pin_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own kernel library already builds into
    ``build/repro_torch_kernels``).  The executable cache stays off: its
    entries hold the weights, which differ by seed."""
    build = root / "build" / "bench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    os.environ.pop("REPRO_TORCH_CACHE_DIR", None)
    os.environ["USE_FLAX"] = "0"


def cell_metrics(spec: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: end to end untraced, per
    layer traced; a metric without ``workloads`` is every cell's."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader_path(name: str, here: Path = HERE) -> Path:
    """A metric's reader: ``metrics/<name>.py``, else, for a quantity
    split by the end-to-end metric it moves (``<quantity>.<part>``), the
    quantity's ``metrics/<quantity>.py``."""
    own = here / "metrics" / f"{name}.py"
    return own if own.is_file() or "." not in name else \
        here / "metrics" / f"{name.rsplit('.', 1)[0]}.py"


def read_metrics(entries: List[Dict], ctx: Dict, here: Path = HERE
                 ) -> Dict[str, Dict]:
    """Each metric's reader on the run's record; a reader that finds
    nothing to read leaves its metric out."""
    out = {}
    for m in entries:
        reader = load_module(reader_path(m["name"], here),
                             f"bench_metric_{len(out)}")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def finite(v):
    """``v``, or None where nothing was compared (no number, or NaN)."""
    return v if v is not None and math.isfinite(v) else None


def holds(c: Dict) -> bool:
    v = finite(c["value"])
    if v is None:
        return False
    return v <= c["limit"] if c["holds"] == "<=" else v >= c["limit"]


def run_cell(spec: Dict, cell: str, seed: int, seconds: float, trace: bool,
             t0: float, device: str = "cuda", control: bool = False,
             here: Path = HERE, overrides: Optional[Dict] = None) -> Dict:
    """Run ``cell`` once; its result line (a dict).  ``overrides`` maps
    ``config``/``mix``/``limits`` to dicts used in place of the files
    (a small rehearsal on the CPU).  With ``control`` the check judges
    the control's numbers (the reference in the precision below the
    configuration's, on the same inputs) in the program's place, so a
    sound check reports ``correct: false``; the program's own numbers
    stay beside it under ``program_check``."""
    entry = next(w for w in spec["workloads"] if w["name"] == cell)
    overrides = overrides or {}
    config = overrides.get("config") or load_json(
        here / "configs" / f"{entry['config']}.json")
    mix = overrides.get("mix") or load_json(
        here / "traffic" / f"{entry['traffic']}.json")
    limits = overrides.get("limits") or load_json(
        here / "cells" / f"{cell}.json")["limits"]
    reference = importlib.import_module(f"bench.refs.{config['reference']}")
    system = importlib.import_module(f"bench.systems.{config['system']}")
    r = Run(cell=cell, config=config, mix=mix, limits=limits,
            reference=reference, seed=seed, seconds=seconds, trace=trace,
            t0=t0, out_dir=here.parent / "build" / "bench" / "traces",
            device=device, control=control, here=here)
    ctx = system.run(r)
    check = ctx["control_check"] if control else ctx["check"]
    result = {
        "correct": all(holds(c) for c in check.values()),
        "attempted": ctx["attempted"], "failed": ctx["failed"],
        "metrics": read_metrics(cell_metrics(spec, cell, trace), ctx, here),
        "device": device_record(device, entry["chips"],
                                ctx["memory_peak_bytes"]),
    }
    tr = ctx.get("trace")
    if trace and device != "cpu" and not (tr and tr["busy_s"] > 0):
        raise RuntimeError("the traced slice holds no device time")
    if trace and tr:
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    if control:
        result["program_check"] = _plain(ctx["check"])
    result["check"] = _plain(check)                         # the last key
    return result


def _plain(check: Dict) -> Dict:
    """A check as printed: each number (None where nothing was compared)
    beside its limit."""
    return {k: dict(c, value=finite(c["value"])) for k, c in check.items()}


def device_record(device: str, chips: int, peak: int) -> Dict:
    import torch
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}


def check_lines(result: Dict) -> List[str]:
    return [f"check {k} {c['value']!r} {c['holds']} {c['limit']!r}"
            for k, c in result["check"].items()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="judge the control in the program's place: the "
                        "reference in the precision below the "
                        "configuration's, on the same inputs; a sound check "
                        "prints correct false (not a run the benchmark "
                        "makes)")
    args = p.parse_args(argv)
    spec = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    pin_caches(ROOT)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), T0, control=bool(args.control))
    from bench.guard import forbidden_modules
    bad = forbidden_modules()
    if bad:
        print(f"the process loaded {bad}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    print("\n".join(check_lines(result)), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
