"""MV103 — artifact writes go through the committed helpers.

Any JSON/manifest/journal artifact written by the durable subsystems
must go through ``resilience.io.atomic_write_text`` (whole-document
commits) or the telemetry ``JsonlSink`` (append-only trails) — a bare
``open(..., "w")`` or ``Path.write_text`` is a torn-write hazard where
a kill mid-write leaves half a manifest.

Scope in package mode: ``bankops/``, ``serving/``, ``resilience/`` and
``telemetry/``.  The modules that *implement* the committed helpers
carry inline ``lint: disable=MV103`` justifications — the open calls
there ARE the helper.  On a fixture dir every file is in scope.

Flagged:

* ``open(...)`` whose mode (2nd positional or ``mode=``) contains any
  of ``w``/``a``/``x``/``+`` — read-only opens are fine; a *dynamic*
  mode is flagged too (artifact writes must be static);
* ``.write_text(...)`` / ``.write_bytes(...)`` attribute calls.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..engine import AnalysisContext, Finding, register

CODE = "MV103"

SCOPED_DIRS = ("bankops", "serving", "resilience", "telemetry")
WRITE_MODE_CHARS = set("wax+")
FORBIDDEN_ATTRS = {"write_text", "write_bytes"}


def _open_write_mode(node: ast.Call) -> bool:
    func = node.func
    name = func.id if isinstance(func, ast.Name) else (
        func.attr if isinstance(func, ast.Attribute) else ""
    )
    if name != "open":
        return False
    mode = node.args[1] if len(node.args) >= 2 else None
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return False  # default "r"
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return bool(set(mode.value) & WRITE_MODE_CHARS)
    return True  # dynamic mode: flag it — artifact writes must be static


@register(
    CODE,
    "artifact-write",
    "direct artifact write — use atomic_write_text or JsonlSink",
)
def check(ctx: AnalysisContext) -> Iterator[Finding]:
    for pf in ctx.files:
        if pf.tree is None or not ctx.in_dirs(pf, SCOPED_DIRS):
            continue
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Call):
                continue
            if _open_write_mode(node):
                symbol = "open"
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in FORBIDDEN_ATTRS
            ):
                symbol = node.func.attr
            else:
                continue
            yield Finding(
                CODE, pf.rel, node.lineno,
                f"direct artifact write ({symbol}) — commit through "
                "resilience.io.atomic_write_text or the telemetry "
                "JsonlSink",
                symbol=symbol,
            )
