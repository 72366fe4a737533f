"""MV301/MV302/MV303 — lock discipline in thread-spawning classes (the
JAX package's checkers; the blocking set adds eager PyTorch's syncs).

The serving tier runs several threads (micro-batcher, router monitor,
shadow worker, drift monitor, prefetch feeder).  These checkers make
their lock conventions machine-checked, scoped to classes that actually
spawn a ``threading.Thread`` (the only classes where two threads can
contend):

* **MV301 blocking-under-lock** — inside a ``with self._lock:`` /
  ``with self._cond:`` block, no blocking work: ``sleep``/``join``/
  ``result``, scoring/encoding entry points (``predict*``, ``score_*``,
  ``encode_bank``/``encode_anchors``/``encode_many``, ``warmup_*``),
  device syncs (``torch.cuda.synchronize`` and an event's or stream's
  ``.synchronize()``, ``.item()``, ``.cpu()``, ``.tolist()``, and the JAX
  names ``device_get``, ``block_until_ready``) or file I/O
  (``open``, ``read_text``, ``write_text``, ``write_bytes``,
  ``atomic_write_text``).  A batcher holding its queue condition while
  the device scores starves every submitter in the process.
  ``Condition.wait`` is the one sanctioned block — it *releases* the
  lock.
* **MV302 bare-acquire** — ``lock.acquire()`` outside a
  ``try/finally: release()`` (and not as a ``with``): an exception
  between acquire and release deadlocks every other thread forever.
* **MV303 unguarded-shared-attr** — an instance attribute assigned
  both from a thread-target method (or a method reachable from one
  inside the class) and from a public method, where at least one of
  the writes is not under a ``with <lock>`` block.  That is the
  classic torn-state race: control plane and worker both write, nobody
  synchronizes.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..engine import AnalysisContext, Finding, ParsedFile, called_name, register

BLOCKING_NAMES = {
    "sleep", "join", "result",
    "encode_bank", "encode_anchors", "encode_many",
    "device_get", "block_until_ready",
    "synchronize", "item", "cpu", "tolist",
    "open", "read_text", "write_text", "write_bytes", "atomic_write_text",
}
BLOCKING_PREFIXES = ("predict", "score_", "warmup_")

_LOCKISH = ("lock", "cond", "mutex")


def _lockish_expr(expr: ast.expr) -> Optional[str]:
    """The lock-ish name a ``with`` context manages, if any:
    ``self._lock`` / ``self._cond`` / a bare ``lock`` variable."""
    name = ""
    if isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    low = name.lower()
    return name if any(t in low for t in _LOCKISH) else None


def _spawns_thread(cls: ast.ClassDef) -> bool:
    return any(
        isinstance(n, ast.Call) and called_name(n) == "Thread"
        for n in ast.walk(cls)
    )


def _with_lock_blocks(node: ast.AST) -> Iterator[Tuple[str, ast.With]]:
    for n in ast.walk(node):
        if isinstance(n, ast.With):
            for item in n.items:
                lock = _lockish_expr(item.context_expr)
                if lock is not None:
                    yield lock, n


def _under_lock(pf: ParsedFile, node: ast.AST) -> bool:
    for anc in pf.ancestors(node):
        if isinstance(anc, ast.With) and any(
            _lockish_expr(i.context_expr) for i in anc.items
        ):
            return True
    return False


@register(
    "MV301",
    "blocking-under-lock",
    "blocking call while holding a lock in a thread-spawning class",
)
def check_blocking_under_lock(ctx: AnalysisContext) -> Iterator[Finding]:
    for pf in ctx.files:
        if pf.tree is None:
            continue
        for cls in ast.walk(pf.tree):
            if not (isinstance(cls, ast.ClassDef) and _spawns_thread(cls)):
                continue
            for lock, block in _with_lock_blocks(cls):
                for stmt in block.body:
                    for call in ast.walk(stmt):
                        if not isinstance(call, ast.Call):
                            continue
                        name = called_name(call)
                        if name in BLOCKING_NAMES or name.startswith(
                            BLOCKING_PREFIXES
                        ):
                            yield Finding(
                                "MV301", pf.rel, call.lineno,
                                f"blocking call {name}() while holding "
                                f"{lock} in {cls.name} — move the work "
                                "outside the lock (snapshot under the "
                                "lock, act outside it)",
                                symbol=name,
                            )


def _releases(try_node: ast.Try) -> bool:
    return any(
        isinstance(n, ast.Call) and called_name(n) == "release"
        for stmt in try_node.finalbody
        for n in ast.walk(stmt)
    )


def _acquire_guarded(pf: ParsedFile, call: ast.Call) -> bool:
    """True for the two sanctioned shapes: the acquire INSIDE a
    ``try/finally: release()``, or the canonical idiom — the acquire
    statement immediately FOLLOWED by such a try."""
    node: ast.AST = call
    for anc in pf.ancestors(call):
        if isinstance(anc, ast.Try) and _releases(anc):
            return True
        body = getattr(anc, "body", None)
        if isinstance(body, list) and node in body:
            idx = body.index(node)
            if (
                idx + 1 < len(body)
                and isinstance(body[idx + 1], ast.Try)
                and _releases(body[idx + 1])
            ):
                return True
        node = anc
    return False


@register(
    "MV302",
    "bare-acquire",
    "lock.acquire() without try/finally release()",
)
def check_bare_acquire(ctx: AnalysisContext) -> Iterator[Finding]:
    for pf in ctx.files:
        if pf.tree is None:
            continue
        for call in ast.walk(pf.tree):
            if not (
                isinstance(call, ast.Call)
                and called_name(call) == "acquire"
                and isinstance(call.func, ast.Attribute)
            ):
                continue
            if not _acquire_guarded(pf, call):
                yield Finding(
                    "MV302", pf.rel, call.lineno,
                    "bare acquire() without try/finally release() — an "
                    "exception between them deadlocks every other "
                    "thread; prefer `with lock:`",
                    symbol="acquire",
                )


def _thread_target_names(cls: ast.ClassDef) -> Set[str]:
    targets: Set[str] = set()
    for call in ast.walk(cls):
        if not (isinstance(call, ast.Call) and called_name(call) == "Thread"):
            continue
        for kw in call.keywords:
            if kw.arg != "target":
                continue
            if isinstance(kw.value, ast.Attribute):
                targets.add(kw.value.attr)
            elif isinstance(kw.value, ast.Name):
                targets.add(kw.value.id)
    return targets


def _self_attr_writes(
    method: ast.FunctionDef, pf: ParsedFile
) -> List[Tuple[str, int, bool]]:
    """(attr, line, under_lock) for every ``self.attr = ...`` write."""
    out: List[Tuple[str, int, bool]] = []
    for node in ast.walk(method):
        targets: List[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            if (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
            ):
                out.append((t.attr, node.lineno, _under_lock(pf, node)))
    return out


@register(
    "MV303",
    "unguarded-shared-attr",
    "instance attribute written by both a worker thread and a public "
    "method without a lock",
)
def check_unguarded_shared_attrs(ctx: AnalysisContext) -> Iterator[Finding]:
    for pf in ctx.files:
        if pf.tree is None:
            continue
        for cls in ast.walk(pf.tree):
            if not (isinstance(cls, ast.ClassDef) and _spawns_thread(cls)):
                continue
            methods: Dict[str, ast.FunctionDef] = {
                n.name: n for n in cls.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
            targets = _thread_target_names(cls) & set(methods)
            if not targets:
                continue
            # methods reachable from the thread target within the class
            worker: Set[str] = set()
            frontier = list(targets)
            while frontier:
                name = frontier.pop()
                if name in worker:
                    continue
                worker.add(name)
                for call in ast.walk(methods[name]):
                    if isinstance(call, ast.Call):
                        callee = called_name(call)
                        if callee in methods and callee not in worker:
                            frontier.append(callee)
            writes: Dict[str, List[Tuple[str, int, bool]]] = {}
            for name, method in methods.items():
                if name == "__init__":
                    continue  # construction happens-before the thread
                for attr, line, locked in _self_attr_writes(method, pf):
                    writes.setdefault(attr, []).append((name, line, locked))
            for attr, sites in sorted(writes.items()):
                worker_sites = [s for s in sites if s[0] in worker]
                public_sites = [
                    s for s in sites
                    if s[0] not in worker and not s[0].startswith("_")
                ]
                if not worker_sites or not public_sites:
                    continue
                unlocked = [
                    s for s in worker_sites + public_sites if not s[2]
                ]
                if not unlocked:
                    continue
                name, line, _ = unlocked[0]
                yield Finding(
                    "MV303", pf.rel, line,
                    f"{cls.name}.{attr} is written by worker-thread "
                    f"method {worker_sites[0][0]}() and public method "
                    f"{public_sites[0][0]}() but the write in {name}() "
                    "holds no lock — guard both writes with one lock",
                    symbol=attr,
                )
