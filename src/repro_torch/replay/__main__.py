"""CLI entry point: ``python -m repro_torch.replay <bundle> [--tol F] [--json]``.

Exit codes: 0 = the bundle reproduces bit-identically (or within
``--tol``), 1 = any selection/decision/output divergence, 2 = the bundle
cannot be replayed: unreadable, failing its manifest hash check
(tampered), or recorded on a CUDA device where there is none.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import BundleError, replay_bundle


def main(argv=None) -> int:
    """Parse args, replay the bundle, translate results to exit codes."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.replay",
        description="Re-run a repro_torch capture bundle and diff it "
                    "against the recorded compile.")
    ap.add_argument("bundle", help="path to the capture bundle directory")
    ap.add_argument("--tol", type=float, default=0.0,
                    help="allclose tolerance for output comparison "
                         "(default 0 = bit-exact)")
    ap.add_argument("--json", action="store_true",
                    help="print the result as JSON instead of prose")
    args = ap.parse_args(argv)

    try:
        result = replay_bundle(args.bundle, tol=args.tol,
                               verbose=not args.json)
    except BundleError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(result, indent=2, default=str))
    if result["divergences"]:
        if not args.json:
            for d in result["divergences"]:
                print(f"DIVERGENCE: {d}")
            print(f"replay FAILED: {len(result['divergences'])} "
                  f"divergence(s)")
        return 1
    if not args.json:
        print("replay OK: bundle reproduces the recorded compile")
    return 0


if __name__ == "__main__":
    sys.exit(main())
