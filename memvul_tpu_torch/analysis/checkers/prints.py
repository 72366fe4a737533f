"""MV101 — no bare ``print(`` in library code.

Library output goes through ``logging`` (operator-facing) or the
telemetry registry (machine-facing, the metric catalog in
``memvul_tpu_torch/docs/observability.md``).  A bare print from deep
inside a scoring stream corrupts the one-JSON-line stdout contract of
the bench/CLI entry points and is invisible to ``telemetry-report``.
The two intentional stdout writers are exempt by filename —
``bench.py`` (its stdout IS the result contract) and ``__main__.py``
(the CLI's user-facing output) — wherever they live, as is the lint
CLI itself (``analysis/cli.py``, in package mode only).
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..engine import AnalysisContext, Finding, register

CODE = "MV101"

# files whose stdout is an intentional, documented contract
ALLOWED_FILES = {"bench.py", "__main__.py"}
# the lint CLI renders findings on stdout — same contract, but only
# the real one (not a fixture file that happens to share the name)
ALLOWED_PACKAGE_FILES = {"analysis/cli.py"}


@register(
    CODE,
    "bare-print",
    "bare print() in library code — use logging or the telemetry registry",
)
def check(ctx: AnalysisContext) -> Iterator[Finding]:
    for pf in ctx.files:
        if pf.path.name in ALLOWED_FILES or pf.tree is None:
            continue
        if ctx.is_package and ctx.rel_to_root(pf) in ALLOWED_PACKAGE_FILES:
            continue
        for node in ast.walk(pf.tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "print"
            ):
                yield Finding(
                    CODE, pf.rel, node.lineno,
                    "bare print() in library code — use logging or the "
                    "telemetry registry",
                    symbol="print",
                )
