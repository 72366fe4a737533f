"""MV201 — no host side effects inside a model's forward.

The JAX package's checker guards traced (jit/Pallas/scan) code.  Eager
PyTorch traces nothing, but the same rule keeps the card busy: the host
queues a forward's kernels ahead of the device, and a ``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()`` or ``torch.cuda.synchronize()``
inside it makes the host wait for the device to drain before it can queue
the next launch, so the launch queue runs dry on every call.  Host launch
cost is the port's first bottleneck, so this checker guards what the
speed work needs.  A ``print``, host clock, host RNG or telemetry call
there runs once per call, in the hot path.

The checker builds an intra-package call-graph approximation:

* **roots** — every method of an ``nn.Module`` subclass (a base whose
  name ends with ``Module``, or a class of the scoped files that derives
  from one) but its constructor, ``forward``/``backward`` of a
  ``torch.autograd.Function`` subclass, and functions passed (by name)
  to ``torch.utils.checkpoint.checkpoint``.  ``__init__`` is neither a
  root nor an edge: a module is built once, before any forward, where a
  flax module's ``setup`` is traced with it;
* **edges** — call sites resolved by terminal name against the
  function-def index of the scoped files (``models/``, ``ops/``,
  ``training/``, ``evaluate/`` in package mode — the model stack, the
  kernels' wrappers, and the trainer/predictor step fns).

Inside reachable functions (own body only — nested defs are reached via
edges) it flags: ``print``, ``time.*``, ``random.*`` / ``np.random.*``,
the device→host syncs ``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, ``.synchronize()`` (``torch.cuda``'s, an event's or a
stream's), the host→device copies ``torch.tensor(..., device=...)`` and
``torch.as_tensor(..., device=...)`` (a copy from pageable host memory,
which waits for the card: a constant belongs on the host, or in
``torch.full`` on the device), and the JAX names ``jax.device_get`` /
``.block_until_ready()``,
telemetry emission chains (``...counter(...).inc()`` etc. and registry
``event``/``span``/``heartbeat`` calls), and ``float()`` / ``int()``
applied directly to a parameter of the function.

Intentional host work carries an inline ``lint: disable=MV201``
justification.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..engine import AnalysisContext, Finding, ParsedFile, called_name, register

CODE = "MV201"

SCOPED_DIRS = ("models", "ops", "training", "evaluate")

# call wrappers whose function-valued arguments run inside a forward
FORWARD_WRAPPERS = {"checkpoint"}
# torch.autograd.Function's methods that run in the forward and backward
AUTOGRAD_METHODS = {"forward", "backward"}
# construction runs once, outside every forward
CONSTRUCTOR = "__init__"
# device→host syncs, by method name (no arguments needed to match)
SYNC_METHODS = {
    "item": ".item() device→host sync",
    "tolist": ".tolist() device→host sync",
    "cpu": ".cpu() device→host copy",
    "numpy": ".numpy() device→host copy",
    "synchronize": ".synchronize() waits for the device to drain",
    "block_until_ready": ".block_until_ready() waits for the device",
}
# torch constructors that copy host data to the device named by device=
HOST_COPY_CONSTRUCTORS = {"tensor", "as_tensor"}
_TELEMETRY_CHAIN = {"counter", "gauge", "histogram"}
_TELEMETRY_TERMINALS = {"inc", "observe", "set"}
_REGISTRY_CALLS = {"event", "span", "heartbeat", "progress"}

FuncDef = Tuple[ParsedFile, ast.FunctionDef]


def _base_names(cls: ast.ClassDef) -> List[str]:
    return [
        base.attr if isinstance(base, ast.Attribute) else (
            base.id if isinstance(base, ast.Name) else ""
        )
        for base in cls.bases
    ]


def _module_classes(classes: List[ast.ClassDef]) -> Set[str]:
    """Names of the ``nn.Module`` subclasses: a base ending in ``Module``,
    or (to a fixpoint) a base that is one of these classes."""
    names: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for cls in classes:
            if cls.name in names:
                continue
            if any(b.endswith("Module") or b in names for b in _base_names(cls)):
                names.add(cls.name)
                changed = True
    return names


def _own_body_nodes(fn: ast.FunctionDef) -> Iterator[ast.AST]:
    """Walk a function's body without descending into nested function/
    class definitions (those are separate graph nodes)."""
    stack: List[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _receiver_is_registry(func: ast.Attribute) -> bool:
    """``tel.event(...)`` / ``get_registry().span(...)`` — the receiver
    chain names a telemetry registry."""
    value = func.value
    if isinstance(value, ast.Call) and called_name(value) == "get_registry":
        return True
    name = ""
    if isinstance(value, ast.Name):
        name = value.id
    elif isinstance(value, ast.Attribute):
        name = value.attr
    return name.lstrip("_") in {"tel", "telemetry", "registry"}


def _host_effect(node: ast.AST, params: Set[str]) -> Optional[Tuple[str, str]]:
    """(symbol, description) when ``node`` is a host side effect."""
    if not isinstance(node, ast.Call):
        return None
    func = node.func
    name = called_name(node)
    if isinstance(func, ast.Name):
        if name == "print":
            return "print", "print() call"
        if name in ("float", "int") and len(node.args) == 1:
            arg = node.args[0]
            if isinstance(arg, ast.Name) and arg.id in params:
                return name, (
                    f"{name}() on argument {arg.id!r} "
                    "(a tensor's forces a device→host sync)"
                )
        return None
    if not isinstance(func, ast.Attribute):
        return None
    value = func.value
    if isinstance(value, ast.Name):
        if value.id == "time":
            return f"time.{name}", f"time.{name}() host clock call"
        if value.id == "random":
            return f"random.{name}", f"random.{name}() host RNG call"
        if value.id in ("np", "numpy") and name == "random":
            return f"np.{name}", f"np.{name}() host RNG call"
        if value.id == "jax" and name == "device_get":
            return "jax.device_get", "jax.device_get() device→host sync"
        if (value.id == "torch" and name in HOST_COPY_CONSTRUCTORS
                and any(kw.arg == "device" for kw in node.keywords)):
            return f"torch.{name}", (
                f"torch.{name}(..., device=...) host→device copy from pageable "
                "memory, which waits for the card"
            )
    if (
        isinstance(value, ast.Attribute)
        and value.attr == "random"
        and isinstance(value.value, ast.Name)
        and value.value.id in ("np", "numpy")
    ):
        return f"np.random.{name}", f"np.random.{name}() host RNG call"
    if name in SYNC_METHODS and (not node.args or name == "synchronize"):
        return f".{name}", SYNC_METHODS[name]
    if name in _TELEMETRY_TERMINALS and isinstance(value, ast.Call):
        if called_name(value) in _TELEMETRY_CHAIN:
            chain = called_name(value)
            return (
                f"{chain}().{name}",
                f"telemetry {chain}().{name}() emission",
            )
    if name in _REGISTRY_CALLS and _receiver_is_registry(func):
        return f"registry.{name}", f"telemetry registry {name}() call"
    return None


def _collect_defs(files: List[ParsedFile]) -> Dict[str, List[FuncDef]]:
    index: Dict[str, List[FuncDef]] = {}
    for pf in files:
        if pf.tree is None:
            continue
        for node in ast.walk(pf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                index.setdefault(node.name, []).append((pf, node))
    return index


def _collect_roots(
    files: List[ParsedFile], index: Dict[str, List[FuncDef]]
) -> Set[str]:
    classes = [
        node for pf in files if pf.tree is not None
        for node in ast.walk(pf.tree) if isinstance(node, ast.ClassDef)
    ]
    modules = _module_classes(classes)
    roots: Set[str] = set()
    for cls in classes:
        methods = [
            item for item in cls.body
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        if cls.name in modules:
            roots.update(m.name for m in methods if m.name != CONSTRUCTOR)
        elif "Function" in _base_names(cls):
            roots.update(m.name for m in methods if m.name in AUTOGRAD_METHODS)
    for pf in files:
        if pf.tree is None:
            continue
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Call) and called_name(node) in FORWARD_WRAPPERS:
                for arg in list(node.args) + [kw.value for kw in node.keywords]:
                    for sub in ast.walk(arg):
                        if isinstance(sub, ast.Name) and sub.id in index:
                            roots.add(sub.id)
    return roots


def _edges(fn: ast.FunctionDef) -> Set[str]:
    out: Set[str] = set()
    for node in _own_body_nodes(fn):
        if isinstance(node, ast.Call):
            name = called_name(node)
            if name and name != CONSTRUCTOR:
                out.add(name)
    return out


@register(
    CODE,
    "forward-impure",
    "host sync or side effect inside code reachable from an nn.Module, "
    "an autograd.Function or a checkpointed function",
)
def check(ctx: AnalysisContext) -> Iterator[Finding]:
    files = [
        pf for pf in ctx.files if ctx.in_dirs(pf, SCOPED_DIRS)
    ]
    index = _collect_defs(files)
    roots = _collect_roots(files, index)
    reachable: Set[str] = set()
    frontier = [r for r in roots if r in index]
    while frontier:
        name = frontier.pop()
        if name in reachable:
            continue
        reachable.add(name)
        for _, fn in index[name]:
            for callee in _edges(fn):
                if callee in index and callee not in reachable:
                    frontier.append(callee)
    seen: Set[Tuple[str, int, str]] = set()
    for name in sorted(reachable):
        for pf, fn in index[name]:
            params = {
                a.arg for a in (
                    fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
                )
                if a.arg not in ("self", "cls", "ctx")
            }
            for node in _own_body_nodes(fn):
                effect = _host_effect(node, params)
                if effect is None:
                    continue
                symbol, desc = effect
                key = (pf.rel, node.lineno, symbol)
                if key in seen:
                    continue
                seen.add(key)
                yield Finding(
                    CODE, pf.rel, node.lineno,
                    f"host side effect in forward code: {desc} inside "
                    f"{name}() (reachable from an nn.Module, autograd."
                    "Function or checkpoint entry) — hoist it out of the "
                    "forward",
                    symbol=symbol,
                )
