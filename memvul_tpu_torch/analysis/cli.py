"""``python -m memvul_tpu_torch lint``: the engine's command line (the
JAX package's ``analysis/cli.py``, with the same flags and schema).

Human output is one ``path:line: CODE message`` per active finding;
``--json`` emits the stable machine schema.  Exit codes: 0 clean (inline
suppressions and baselined findings don't fail), 1 active findings, 2
usage error.  ``--write-baseline`` rewrites the committed baseline from
the current active findings: the sanctioned way to grandfather a
finding, though an inline suppression comment with a one-line
justification is preferred.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional


def add_lint_arguments(parser: argparse.ArgumentParser) -> None:
    """The ``lint`` subcommand's flag surface (shared with tests)."""
    parser.add_argument(
        "--select", default=None, metavar="CODE,...",
        help="run only these checker codes (e.g. MV101,MV301)",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="emit the machine-readable result document on stdout",
    )
    parser.add_argument(
        "--root", default=None, metavar="DIR",
        help="analyze this directory instead of the installed package "
        "(docs/tests reconciliation only runs against the repo layout)",
    )
    parser.add_argument(
        "--baseline", default=None, metavar="FILE",
        help="baseline JSON (default: the committed analysis/baseline.json)",
    )
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline — every finding is active",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="rewrite the baseline file from the current active findings",
    )
    parser.add_argument(
        "--list-codes", action="store_true",
        help="print the checker catalog (code, name, description) and exit",
    )


def run_lint(args: argparse.Namespace) -> int:
    from . import (
        BASELINE_PATH,
        CHECKERS,
        analyze,
        analyze_repo,
        baseline_document,
        load_baseline,
    )

    if args.list_codes:
        from .engine import SYNTAX_ERROR_CODE

        print(f"{SYNTAX_ERROR_CODE}  syntax-error  file does not parse")
        for code in sorted(CHECKERS):
            c = CHECKERS[code]
            print(f"{c.code}  {c.name}  {c.description}")
        return 0

    select: Optional[List[str]] = None
    if args.select:
        select = [c.strip() for c in args.select.split(",") if c.strip()]
    baseline_path: Optional[Path]
    if args.no_baseline:
        baseline_path = None
    elif args.baseline:
        baseline_path = Path(args.baseline)
    else:
        baseline_path = BASELINE_PATH

    try:
        if args.root:
            root = Path(args.root)
            if not root.is_dir():
                print(f"lint: {root} is not a directory", file=sys.stderr)
                return 2
            result = analyze(
                root, base_dir=root, select=select,
                baseline=load_baseline(baseline_path) if baseline_path else [],
            )
        else:
            result = analyze_repo(select=select, baseline_path=baseline_path)
    except ValueError as e:  # unknown --select code
        print(f"lint: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        target = baseline_path or BASELINE_PATH
        target.write_text(
            baseline_document(result.active + result.baselined)
        )
        print(f"baseline written: {target} "
              f"({len(result.active) + len(result.baselined)} entries)")
        return 0

    if args.json:
        print(json.dumps(result.to_json(), indent=2))
        return 1 if result.active else 0

    for f in result.active:
        print(f"{f.path}:{f.line}: {f.code} {f.message}")
    for e in result.stale_baseline:
        print(
            f"stale baseline entry (delete it): {e['code']} {e['path']} "
            f"{e['message']!r}",
            file=sys.stderr,
        )
    print(
        f"{len(result.active)} finding(s) "
        f"({len(result.suppressed)} suppressed, "
        f"{len(result.baselined)} baselined) — "
        f"{result.parse_count} file(s) parsed once in "
        f"{result.elapsed_s:.2f}s"
    )
    return 1 if result.active else 0
