"""CLI: python -m repro_torch.analysis [paths...] [--json] [--baseline [FILE]]

Exit codes: 0 clean, 1 new findings, 2 stale baseline entries.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .runner import BASELINE_NAME, render_human, render_json, repo_root, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static invariant passes for the resilience "
                    "contract (journal coverage, ledger charging, "
                    "determinism, kind exhaustiveness, step-name "
                    "stability).")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to scan (default: "
                         "src/repro_torch/{core,cluster,train})")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--baseline", nargs="?", const=True, default=None,
                    metavar="FILE",
                    help=f"apply the grandfathered-findings baseline "
                         f"(default file: {BASELINE_NAME} at the repo "
                         f"root)")
    args = ap.parse_args(argv)

    baseline_path = None
    if args.baseline is not None:
        baseline_path = (repo_root() / BASELINE_NAME
                         if args.baseline is True else Path(args.baseline))
    result = run(paths=args.paths or None, baseline_path=baseline_path)
    out = render_json(result) if args.as_json else render_human(result)
    print(out)
    return result.exit_code


if __name__ == "__main__":
    sys.exit(main())
