"""MV401–MV405 — cross-file registry drift (the JAX package's
``analysis/checkers/drift.py``; MV405 carries the port's meaning).

The port keeps several name registries that code, tests and docs must
agree on.  Five checkers, all over the one shared parse:

* **MV401 unregistered-fault-point** — every fault point named in a
  ``MEMVUL_FAULTS`` spec (tests/docs) or passed to ``fault_point()``
  in package code must be registered in
  ``resilience/faults.py:REGISTERED_POINTS`` (dynamic families like
  ``step.<n>`` register their prefix in
  ``REGISTERED_POINT_PREFIXES``).  A typo'd chaos spec otherwise tests
  nothing, silently.
* **MV402 undocumented-metric** — every ``counter(...)`` /
  ``gauge(...)`` / ``histogram(...)`` name emitted in package code
  must appear in the metric tables of the docs corpus (the port's
  catalog, ``memvul_tpu_torch/docs/observability.md``).  Dynamic names
  (``bank.anchor_wins.<id>``) match by literal prefix.
* **MV403 stale-metric-doc** — the reverse direction: every
  counter/gauge/histogram row in those tables must correspond to a
  name the code can emit (``span``/``derived`` rows are exempt — spans
  are emitted by the registry itself, derived values by
  telemetry-report).
* **MV404 unknown-config-key** — every ``cfg["key"]`` / ``cfg.get``
  access on a variable assigned from a ``config.*_config()`` section
  reader must resolve against the matching ``config.*_DEFAULTS`` dict;
  a typo'd key otherwise silently reads the default forever.
* **MV405 registry-bypass-build** — the port's kernels are built in one
  place, ``ops/_kernels.py``, whose build the program registry records
  as the ``kernels:<library>`` row (``telemetry/programs.py``).  An
  ``nvcc`` invocation (a process call whose arguments name ``nvcc`` or
  ``find_nvcc()``) or a ``torch.utils.cpp_extension.load*`` call
  anywhere else builds a kernel that row, ``/programz`` and the
  roofline report never see.  (The JAX package's MV405 guards its
  ``.lower().compile()`` chokepoint the same way.)  An intentional
  build elsewhere carries a justified inline disable.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..engine import (
    AnalysisContext,
    Finding,
    ParsedFile,
    called_name,
    const_str,
    fstring_prefix,
    module_str_constants,
    register,
)

# -- MV401: fault points -------------------------------------------------------

# point[@n]=action clauses inside MEMVUL_FAULTS-style spec strings; real
# injection points are dotted — single-token names ("a=raise") are the
# fault-parser unit tests' fixtures, not registry members
_FAULT_SPEC_RE = re.compile(
    r"([A-Za-z_][\w-]*(?:\.[\w.-]+)+)(?:@\d+)?=(?:raise|sigterm|sigint|sigkill)\b"
)
_FAULT_CALL_RE = re.compile(r"""fault_point\(\s*["']([^"']+)["']\s*\)""")


def _fault_registry(
    ctx: AnalysisContext,
) -> Optional[Tuple[Set[str], Tuple[str, ...]]]:
    pf = next(
        (p for p in ctx.files
         if ctx.rel_to_root(p) == "resilience/faults.py"),
        None,
    )
    if pf is None or pf.tree is None:
        return None
    points: Set[str] = set()
    prefixes: List[str] = []
    for node in pf.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        target = node.targets[0]
        if not isinstance(target, ast.Name):
            continue
        values = node.value
        if isinstance(values, ast.Call) and called_name(values) in (
            "frozenset", "set", "tuple",
        ):
            values = values.args[0] if values.args else None
        if not isinstance(values, (ast.Set, ast.Tuple, ast.List)):
            continue
        items = [const_str(e) for e in values.elts]
        if any(i is None for i in items):
            continue
        if target.id == "REGISTERED_POINTS":
            points.update(items)  # type: ignore[arg-type]
        elif target.id == "REGISTERED_POINT_PREFIXES":
            prefixes.extend(items)  # type: ignore[arg-type]
    if not points:
        return None
    return points, tuple(prefixes)


def _fault_registered(
    name: str, points: Set[str], prefixes: Tuple[str, ...]
) -> bool:
    if name in points:
        return True
    return any(name.startswith(p) or name == p.rstrip(".") for p in prefixes)


@register(
    "MV401",
    "unregistered-fault-point",
    "fault point name not registered in resilience/faults.py",
)
def check_fault_points(ctx: AnalysisContext) -> Iterator[Finding]:
    registry = _fault_registry(ctx)
    if registry is None:
        return  # no machine-readable registry to check against
    points, prefixes = registry
    for pf in ctx.files:
        if pf.tree is None or ctx.rel_to_root(pf).startswith("resilience/"):
            continue
        for node in ast.walk(pf.tree):
            if not (
                isinstance(node, ast.Call)
                and called_name(node) == "fault_point"
                and node.args
            ):
                continue
            name = const_str(node.args[0])
            if name is None:
                prefix = fstring_prefix(node.args[0])
                if prefix is None or _fault_registered(
                    prefix, points, prefixes
                ):
                    continue
                name = prefix
            elif _fault_registered(name, points, prefixes):
                continue
            yield Finding(
                "MV401", pf.rel, node.lineno,
                f"fault point {name!r} is not registered in "
                "resilience/faults.py REGISTERED_POINTS — register it "
                "(and document it in the table) or fix the name",
                symbol=name,
            )
    for tf in list(ctx.tests) + list(ctx.docs):
        for i, line in enumerate(tf.lines, start=1):
            for m in list(_FAULT_SPEC_RE.finditer(line)) + list(
                _FAULT_CALL_RE.finditer(line)
            ):
                name = m.group(1)
                if "." not in name:
                    continue
                if not _fault_registered(name, points, prefixes):
                    yield Finding(
                        "MV401", tf.rel, i,
                        f"fault point {name!r} referenced here is not "
                        "registered in resilience/faults.py "
                        "REGISTERED_POINTS — the chaos spec would arm "
                        "nothing",
                        symbol=name,
                    )


# -- MV402/MV403: metric names vs docs tables ----------------------------------

_METRIC_NAME_RE = re.compile(
    r"^[a-z][a-z0-9_]*(?:\.[a-z0-9_<>*-]+)+$"
)
_BACKTICK_RE = re.compile(r"`([^`]+)`")
_METRIC_KINDS = ("counter", "gauge", "histogram", "span", "derived")

_EMITTERS = {"counter", "gauge", "histogram"}
# the registry/report machinery itself and the engine are not emitters
_EMITTER_EXEMPT_DIRS = ("telemetry", "analysis")


class _DocEntry:
    def __init__(self, name: str, kind: str, rel: str, line: int) -> None:
        self.name = name
        self.kind = kind
        self.rel = rel
        self.line = line
        # "bank.anchor_wins.<id>" → literal prefix "bank.anchor_wins."
        cut = len(name)
        for marker in ("<", "*"):
            pos = name.find(marker)
            if pos != -1:
                cut = min(cut, pos)
        self.prefix = name[:cut] if cut < len(name) else None

    def matches(self, emitted: str, dynamic: bool) -> bool:
        if self.prefix is None:
            return not dynamic and emitted == self.name
        return emitted.startswith(self.prefix) or (
            dynamic and self.prefix.startswith(emitted)
        )


def _doc_metric_entries(ctx: AnalysisContext) -> List[_DocEntry]:
    entries: List[_DocEntry] = []
    for tf in ctx.docs:
        for i, line in enumerate(tf.lines, start=1):
            stripped = line.strip()
            if not stripped.startswith("|"):
                continue
            cells = [c.strip() for c in stripped.strip("|").split("|")]
            if len(cells) < 2:
                continue
            kind = next(
                (k for k in _METRIC_KINDS
                 if any(re.search(rf"\b{k}s?\b", c) for c in cells[1:])),
                None,
            )
            if kind is None:
                continue
            for token in _BACKTICK_RE.findall(cells[0]):
                if _METRIC_NAME_RE.match(token):
                    entries.append(_DocEntry(token, kind, tf.rel, i))
    return entries


def _emitted_metrics(
    ctx: AnalysisContext,
) -> List[Tuple[str, bool, str, int]]:
    """(name, is_dynamic_prefix, rel, line) for every metric emission."""
    out: List[Tuple[str, bool, str, int]] = []
    for pf in ctx.files:
        if pf.tree is None or not pf.rel.endswith(".py"):
            continue
        if ctx.is_package and ctx.rel_to_root(pf).split("/")[0] in (
            _EMITTER_EXEMPT_DIRS
        ):
            continue
        constants = module_str_constants(pf)
        for node in ast.walk(pf.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _EMITTERS
                and node.args
            ):
                continue
            arg = node.args[0]
            name = const_str(arg)
            dynamic = False
            if name is None and isinstance(arg, ast.Name):
                name = constants.get(arg.id)
            if name is None:
                name = fstring_prefix(arg)
                dynamic = name is not None
            if name is None or "." not in name:
                continue
            out.append((name, dynamic, pf.rel, node.lineno))
    return out


@register(
    "MV402",
    "undocumented-metric",
    "metric emitted in code but absent from the docs metric tables",
)
def check_undocumented_metrics(ctx: AnalysisContext) -> Iterator[Finding]:
    entries = _doc_metric_entries(ctx)
    if not entries:
        return  # nothing to reconcile against (no docs corpus)
    for name, dynamic, rel, line in _emitted_metrics(ctx):
        if any(e.matches(name, dynamic) for e in entries):
            continue
        shown = f"{name}<…>" if dynamic else name
        yield Finding(
            "MV402", rel, line,
            f"metric {shown!r} is emitted here but missing from the "
            "docs metric tables (the catalog in "
            "memvul_tpu_torch/docs/observability.md) — document it or "
            "drop the emission",
            symbol=name,
        )


@register(
    "MV403",
    "stale-metric-doc",
    "documented metric that no code emits",
)
def check_stale_metric_docs(ctx: AnalysisContext) -> Iterator[Finding]:
    entries = _doc_metric_entries(ctx)
    if not entries:
        return
    emitted = _emitted_metrics(ctx)
    emitted_exact = {name for name, dynamic, _, _ in emitted if not dynamic}
    emitted_prefixes = {name for name, dynamic, _, _ in emitted if dynamic}
    # fallback: a name carried through a variable (e.g. a status→counter
    # dict) still appears as a string constant somewhere in the package
    all_strings: Set[str] = set()
    for pf in ctx.files:
        if pf.tree is None:
            continue
        for node in ast.walk(pf.tree):
            value = const_str(node)
            if value is not None and "." in value:
                all_strings.add(value)
    reported: Set[Tuple[str, str, int]] = set()
    for e in entries:
        if e.kind in ("span", "derived"):
            continue
        if e.prefix is None:
            ok = e.name in emitted_exact or e.name in all_strings
        else:
            ok = any(
                p.startswith(e.prefix) or e.prefix.startswith(p)
                for p in emitted_prefixes
            )
        if ok:
            continue
        key = (e.name, e.rel, e.line)
        if key in reported:
            continue
        reported.add(key)
        yield Finding(
            "MV403", e.rel, e.line,
            f"documented metric {e.name!r} is emitted nowhere in the "
            "package — update the table or restore the emission",
            symbol=e.name,
        )


# -- MV404: config keys vs *_DEFAULTS ------------------------------------------

def _config_defaults(ctx: AnalysisContext) -> Dict[str, Set[str]]:
    """``serving_config`` → key set of ``SERVING_DEFAULTS`` (statically
    extracted from config.py — the engine never imports the package)."""
    pf = next(
        (p for p in ctx.files if ctx.rel_to_root(p) == "config.py"), None
    )
    if pf is None or pf.tree is None:
        return {}
    defaults: Dict[str, Set[str]] = {}
    for node in pf.tree.body:
        targets: List[ast.expr] = []
        value: Optional[ast.expr] = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        for t in targets:
            if (
                isinstance(t, ast.Name)
                and t.id.endswith("_DEFAULTS")
                and isinstance(value, ast.Dict)
            ):
                keys = {
                    const_str(k) for k in value.keys if const_str(k)
                }
                defaults[t.id] = {k for k in keys if k}
    out: Dict[str, Set[str]] = {}
    for name, keys in defaults.items():
        fn_name = name[: -len("_DEFAULTS")].lower() + "_config"
        out[fn_name] = keys
    return out


@register(
    "MV404",
    "unknown-config-key",
    "cfg[\"key\"] access that no config.*_DEFAULTS dict declares",
)
def check_config_keys(ctx: AnalysisContext) -> Iterator[Finding]:
    fn_keys = _config_defaults(ctx)
    if not fn_keys:
        return
    for pf in ctx.files:
        if pf.tree is None or ctx.rel_to_root(pf) == "config.py":
            continue
        # variable → the section reader that produced it (file-scoped
        # name resolution is enough: the readers are called once per
        # entry point and the variable names are idiomatic)
        var_fn: Dict[str, str] = {}
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                fn = called_name(node.value)
                if fn in fn_keys:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            var_fn[t.id] = fn
        if not var_fn:
            continue
        for node in ast.walk(pf.tree):
            key = None
            var = None
            if (
                isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id in var_fn
            ):
                var = node.value.id
                key = const_str(node.slice)
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in var_fn
                and node.args
            ):
                var = node.func.value.id
                key = const_str(node.args[0])
            if key is None or var is None:
                continue
            fn = var_fn[var]
            if key not in fn_keys[fn]:
                defaults_name = fn[: -len("_config")].upper() + "_DEFAULTS"
                yield Finding(
                    "MV404", pf.rel, node.lineno,
                    f"config key {key!r} read from {var} "
                    f"({fn}(...)) is not declared in "
                    f"config.{defaults_name} — a typo here silently "
                    "reads the default forever",
                    symbol=key,
                )


# -- MV405: kernel builds outside the kernel-library chokepoint ---------------

# the one sanctioned build site: ops/_kernels.py (nvcc per source, one
# library, recorded as the program registry's kernels:<library> row)
_BUILD_CHOKEPOINT = "ops/_kernels.py"
_PROCESS_CALLS = {"run", "Popen", "call", "check_call", "check_output", "system"}
_CPP_EXTENSION = "cpp_extension"


def _names_nvcc(node: ast.AST) -> bool:
    """Whether a process call's arguments name the CUDA compiler: a string
    whose last path component is ``nvcc``, a variable called ``nvcc`` or a
    ``find_nvcc()`` call."""
    for sub in ast.walk(node):
        words = (const_str(sub) or "").split()
        if words and words[0].rsplit("/", 1)[-1] == "nvcc":
            return True
        if isinstance(sub, ast.Name) and sub.id == "nvcc":
            return True
        if isinstance(sub, ast.Call) and called_name(sub) == "find_nvcc":
            return True
    return False


def _cpp_extension_names(pf: ParsedFile) -> Set[str]:
    """Names bound by ``from torch.utils.cpp_extension import ...``."""
    names: Set[str] = set()
    for node in ast.walk(pf.tree):
        if (
            isinstance(node, ast.ImportFrom)
            and node.module
            and node.module.split(".")[-1] == _CPP_EXTENSION
        ):
            names.update(a.asname or a.name for a in node.names)
    return names


def _cpp_extension_load(node: ast.Call, imported: Set[str]) -> bool:
    func = node.func
    if isinstance(func, ast.Attribute):
        receiver = func.value
        receiver_name = (
            receiver.attr if isinstance(receiver, ast.Attribute)
            else receiver.id if isinstance(receiver, ast.Name) else ""
        )
        return func.attr.startswith("load") and receiver_name == _CPP_EXTENSION
    return isinstance(func, ast.Name) and func.id in imported and func.id.startswith("load")


@register(
    "MV405",
    "registry-bypass-build",
    "nvcc or cpp_extension.load outside ops/_kernels.py bypasses the "
    "program registry's kernel-library row",
)
def check_registry_bypass_build(ctx: AnalysisContext) -> Iterator[Finding]:
    for pf in ctx.files:
        if pf.tree is None or ctx.rel_to_root(pf) == _BUILD_CHOKEPOINT:
            continue
        imported = _cpp_extension_names(pf)
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Call):
                continue
            if _cpp_extension_load(node, imported):
                symbol = "cpp_extension.load"
            elif called_name(node) in _PROCESS_CALLS and _names_nvcc(node):
                symbol = "nvcc"
            else:
                continue
            yield Finding(
                "MV405", pf.rel, node.lineno,
                f"kernel build ({symbol}) outside ops/_kernels.py bypasses "
                "the program registry's kernels:<library> row — build "
                "through ops/_kernels.build() so the library shows up in "
                "/programz and the roofline report (lint: disable=MV405 "
                "with a justification if a separate build is intentional)",
                symbol=symbol,
            )
