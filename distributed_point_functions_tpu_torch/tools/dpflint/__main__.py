"""CLI: python -m distributed_point_functions_tpu_torch.tools.dpflint
[--update-baseline] [--checker NAME]...

Exit status: 0 clean, 1 findings, 2 usage error. Pure stdlib: it imports
neither torch nor jax, so it runs in seconds anywhere the repo is."""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from . import CHECKER_NAMES, DEFAULT_BASELINE, run
from .core import load_baseline, save_baseline

PROG = "python -m distributed_point_functions_tpu_torch.tools.dpflint"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog=PROG,
        description="AST-enforced invariants of the port (see this package's __init__.py)",
    )
    parser.add_argument(
        "--root", type=Path, default=Path(__file__).resolve().parents[3],
        help="repo root (default: the checkout containing this package)",
    )
    parser.add_argument(
        "--baseline", type=Path, default=DEFAULT_BASELINE,
        help="pinned watch-list baseline (default: this package's baseline.json)",
    )
    parser.add_argument(
        "--checker", action="append", choices=CHECKER_NAMES,
        help=f"run only the named checker(s); default: all {len(CHECKER_NAMES)}",
    )
    parser.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline from the current tree (after a reviewed change)",
    )
    args = parser.parse_args(argv)

    for heavy in ("torch", "jax"):
        assert heavy not in sys.modules, f"dpflint must never import {heavy}"

    baseline = {}
    if args.baseline.is_file():
        baseline = load_baseline(args.baseline)
    elif not args.update_baseline:
        print(f"dpflint: baseline {args.baseline} missing — comparing against empty pins",
              file=sys.stderr)

    t0 = time.monotonic()
    checkers = tuple(args.checker) if args.checker else None
    findings, observed = run(args.root, baseline, checkers=checkers)
    dt = time.monotonic() - t0

    if args.update_baseline:
        merged = dict(baseline)
        merged.update(observed)
        save_baseline(args.baseline, merged)
        print(f"dpflint: baseline updated ({args.baseline})")
        # Violations are not pinnable: re-check against the fresh baseline
        # and report them instead of letting the update swallow them.
        residual, _ = run(args.root, merged, checkers=checkers)
        for f in residual:
            print(f.render())
        if residual:
            print(f"dpflint: {len(residual)} finding(s) remain that a baseline cannot pin")
            return 1
        return 0

    for f in findings:
        print(f.render())
    n = len(checkers or CHECKER_NAMES)
    if findings:
        print(f"dpflint: {len(findings)} finding(s) across {n} checker(s) in {dt:.2f}s")
        return 1
    print(f"dpflint: clean ({n} checkers in {dt:.2f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
