"""The shared static-analysis engine (the JAX package's
``analysis/engine.py``; it is language-neutral and carried over as it is).

One ``ast`` parse per file, shared by every registered checker: a checker
is a function over an :class:`AnalysisContext` that already holds every
parsed file, the docs corpus and the test corpus, so adding an invariant
costs a visitor, not a pass.

Core contracts:

* findings are structured ``{code, path, line, message}`` records
  (:class:`Finding`; ``path`` is POSIX-relative to the analysis base
  dir, ``line`` is **1-based**);
* a ``lint: disable=CODE`` comment on the flagged line suppresses it
  (comma-separated list or ``all``); suppressions are justified inline
  and counted, never silent;
* a committed JSON baseline (``analysis/baseline.json``) grandfathers
  findings by ``(code, path, message)``: deleting an entry makes the
  finding fire again, and stale entries (matching nothing) are reported
  so the baseline can only shrink;
* checkers register through :func:`register` with a stable code; the
  CLI (``python -m memvul_tpu_torch lint``) selects by code and renders
  human or ``--json`` output (analysis/cli.py).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

# engine-level finding: a file that does not parse is its own bug
SYNTAX_ERROR_CODE = "MV001"

_SUPPRESS_RE = re.compile(r"#\s*lint:\s*disable=([A-Za-z0-9_,\s]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One structured finding.  ``path`` is POSIX-relative to the
    engine's base dir; ``line`` is 1-based; ``symbol`` (optional) is the
    offending callable/metric/key name, used by the ``tools/`` shims to
    reproduce their historical output format."""

    code: str
    path: str
    line: int
    message: str
    symbol: Optional[str] = None

    def to_json(self) -> Dict[str, Any]:
        return {
            "code": self.code,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "symbol": self.symbol,
        }

    @property
    def baseline_key(self) -> Tuple[str, str, str]:
        # line numbers churn with unrelated edits; identity for the
        # committed baseline is (code, path, message)
        return (self.code, self.path, self.message)


class ParsedFile:
    """One source file, parsed exactly once and shared by all checkers."""

    def __init__(self, path: Path, rel: str, text: str) -> None:
        self.path = path
        self.rel = rel
        self.text = text
        self.tree: Optional[ast.Module] = None
        self.syntax_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(text, filename=str(path))
        except SyntaxError as e:
            self.syntax_error = e
        self._suppressions: Optional[Dict[int, Set[str]]] = None
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None

    @property
    def suppressions(self) -> Dict[int, Set[str]]:
        """1-based line → set of suppressed codes (``all`` wildcard)."""
        if self._suppressions is None:
            table: Dict[int, Set[str]] = {}
            for i, line in enumerate(self.text.splitlines(), start=1):
                m = _SUPPRESS_RE.search(line)
                if m:
                    table[i] = {
                        c.strip() for c in m.group(1).split(",") if c.strip()
                    }
            self._suppressions = table
        return self._suppressions

    @property
    def parents(self) -> Dict[ast.AST, ast.AST]:
        """child node → parent node (built lazily, once per file)."""
        if self._parents is None:
            parents: Dict[ast.AST, ast.AST] = {}
            if self.tree is not None:
                for node in ast.walk(self.tree):
                    for child in ast.iter_child_nodes(node):
                        parents[child] = node
            self._parents = parents
        return self._parents

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        parents = self.parents
        while node in parents:
            node = parents[node]
            yield node


class TextFile:
    """A non-Python corpus member (docs, test sources scanned as text)."""

    def __init__(self, path: Path, rel: str, text: str) -> None:
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()


class AnalysisContext:
    """Everything a checker may look at.  Built once per run; the
    parse counters prove the whole-tree pass parses each file exactly
    once (pinned by the tier-1 engine test)."""

    def __init__(
        self,
        root: Path,
        base_dir: Optional[Path] = None,
        docs_dir: Optional[Path] = None,
        tests_dir: Optional[Path] = None,
        tests_glob: str = "*.py",
    ) -> None:
        self.root = Path(root).resolve()
        self.base_dir = (
            Path(base_dir).resolve() if base_dir else self.root.parent
        )
        # "package mode" scopes dir-specific checkers to their
        # subsystems; on an arbitrary fixture dir every checker sees
        # every file (the tools/ shim + unit-test contract)
        self.is_package = (self.root / "__main__.py").is_file()
        self.files: List[ParsedFile] = []
        self.parse_count = 0
        for path in sorted(self.root.rglob("*.py")):
            if "__pycache__" in path.parts:
                continue
            rel = path.resolve().relative_to(self.base_dir).as_posix()
            self.files.append(ParsedFile(path, rel, _read(path)))
            self.parse_count += 1
        self.docs: List[TextFile] = _text_corpus(docs_dir, self.base_dir, "*.md")
        self.tests: List[TextFile] = _text_corpus(tests_dir, self.base_dir, tests_glob)
        self._by_rel = {pf.rel: pf for pf in self.files}

    # -- helpers shared by checkers -------------------------------------------

    def file(self, rel: str) -> Optional[ParsedFile]:
        return self._by_rel.get(rel)

    def rel_to_root(self, pf: ParsedFile) -> str:
        """Path relative to the analysis root (subsystem scoping)."""
        return pf.path.relative_to(self.root).as_posix()

    def in_dirs(self, pf: ParsedFile, dirs: Sequence[str]) -> bool:
        """Whether ``pf`` lives under one of ``dirs`` (root-relative).
        Outside package mode every file is in scope — fixture trees
        don't reproduce the package layout."""
        if not self.is_package:
            return True
        rel = self.rel_to_root(pf)
        return any(rel == d or rel.startswith(d.rstrip("/") + "/") for d in dirs)

    def suppressed(self, finding: Finding) -> bool:
        pf = self._by_rel.get(finding.path)
        if pf is None:
            return False
        codes = pf.suppressions.get(finding.line, set())
        return finding.code in codes or "all" in codes


def _read(path: Path) -> str:
    try:
        return path.read_text(encoding="utf-8")
    except UnicodeDecodeError:
        return path.read_text(encoding="utf-8", errors="replace")


def _text_corpus(
    directory: Optional[Path], base_dir: Path, pattern: str
) -> List[TextFile]:
    if directory is None or not Path(directory).is_dir():
        return []
    directory = Path(directory).resolve()
    out = []
    for path in sorted(directory.rglob(pattern)):
        if "__pycache__" in path.parts:
            continue
        try:
            rel = path.relative_to(base_dir).as_posix()
        except ValueError:
            rel = path.as_posix()
        out.append(TextFile(path, rel, _read(path)))
    return out


# -- checker registry ----------------------------------------------------------

CheckerFn = Callable[[AnalysisContext], Iterable[Finding]]


@dataclasses.dataclass(frozen=True)
class Checker:
    code: str
    name: str
    description: str
    fn: CheckerFn


CHECKERS: Dict[str, Checker] = {}


def register(code: str, name: str, description: str):
    """Register ``fn(ctx) -> Iterable[Finding]`` under a stable code.
    Codes are the suppression/selection currency; re-registering a code
    is a programming error."""

    def deco(fn: CheckerFn) -> CheckerFn:
        if code in CHECKERS:
            raise ValueError(f"checker code {code!r} already registered")
        CHECKERS[code] = Checker(code, name, description, fn)
        return fn

    return deco


# -- baseline ------------------------------------------------------------------

def load_baseline(path: Optional[Path]) -> List[Dict[str, str]]:
    """The committed baseline: ``{"version": 1, "findings": [...]}`` or
    a bare list of ``{code, path, message}`` entries."""
    if path is None or not Path(path).is_file():
        return []
    obj = json.loads(Path(path).read_text(encoding="utf-8"))
    entries = obj.get("findings", []) if isinstance(obj, dict) else obj
    out = []
    for e in entries:
        out.append({
            "code": str(e["code"]),
            "path": str(e["path"]),
            "message": str(e["message"]),
        })
    return out


def baseline_document(findings: Sequence[Finding]) -> str:
    entries = sorted(
        {f.baseline_key for f in findings}
    )
    return json.dumps(
        {
            "version": 1,
            "findings": [
                {"code": c, "path": p, "message": m} for c, p, m in entries
            ],
        },
        indent=2,
    ) + "\n"


@dataclasses.dataclass
class AnalysisResult:
    """Partitioned output of one engine run."""

    active: List[Finding]
    suppressed: List[Finding]
    baselined: List[Finding]
    stale_baseline: List[Dict[str, str]]
    parse_count: int
    checked_codes: List[str]
    elapsed_s: float

    def to_json(self) -> Dict[str, Any]:
        """The ``--json`` schema (stability pinned in tests)."""
        by_code: Dict[str, int] = {}
        for f in self.active:
            by_code[f.code] = by_code.get(f.code, 0) + 1
        return {
            "version": 1,
            "findings": [f.to_json() for f in self.active],
            "counts": {
                "active": len(self.active),
                "suppressed": len(self.suppressed),
                "baselined": len(self.baselined),
                "stale_baseline": len(self.stale_baseline),
                "by_code": dict(sorted(by_code.items())),
            },
            "stale_baseline": list(self.stale_baseline),
            "files": self.parse_count,
            "codes": self.checked_codes,
            "elapsed_s": round(self.elapsed_s, 3),
        }


def analyze(
    root: Path,
    base_dir: Optional[Path] = None,
    docs_dir: Optional[Path] = None,
    tests_dir: Optional[Path] = None,
    select: Optional[Iterable[str]] = None,
    baseline: Optional[Sequence[Dict[str, str]]] = None,
    tests_glob: str = "*.py",
) -> AnalysisResult:
    """Run the selected checkers (default: all registered) over one
    shared parse of ``root``, apply inline suppressions and the
    baseline, and return the partitioned result.  ``tests_glob`` picks
    the test corpus's files under ``tests_dir``."""
    start = time.perf_counter()
    ctx = AnalysisContext(
        root, base_dir=base_dir, docs_dir=docs_dir, tests_dir=tests_dir,
        tests_glob=tests_glob,
    )
    codes = sorted(CHECKERS) if select is None else list(select)
    unknown = [c for c in codes if c not in CHECKERS and c != SYNTAX_ERROR_CODE]
    if unknown:
        raise ValueError(
            f"unknown checker code(s) {unknown} (known: {sorted(CHECKERS)})"
        )
    findings: List[Finding] = []
    if SYNTAX_ERROR_CODE in codes or select is None:
        for pf in ctx.files:
            if pf.syntax_error is not None:
                e = pf.syntax_error
                findings.append(Finding(
                    SYNTAX_ERROR_CODE, pf.rel, int(e.lineno or 1),
                    f"syntax error: {e.msg}",
                ))
    for code in codes:
        checker = CHECKERS.get(code)
        if checker is not None:
            findings.extend(checker.fn(ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.code, f.message))

    active: List[Finding] = []
    suppressed: List[Finding] = []
    baselined: List[Finding] = []
    entries = [dict(e) for e in (baseline or [])]
    keys = {(e["code"], e["path"], e["message"]) for e in entries}
    used: Set[Tuple[str, str, str]] = set()
    for f in findings:
        if ctx.suppressed(f):
            suppressed.append(f)
        elif f.baseline_key in keys:
            used.add(f.baseline_key)
            baselined.append(f)
        else:
            active.append(f)
    stale = [
        e for e in entries
        if (e["code"], e["path"], e["message"]) not in used
    ]
    return AnalysisResult(
        active=active,
        suppressed=suppressed,
        baselined=baselined,
        stale_baseline=stale,
        parse_count=ctx.parse_count,
        checked_codes=codes,
        elapsed_s=time.perf_counter() - start,
    )


# -- small AST helpers shared by checkers --------------------------------------

def called_name(node: ast.Call) -> str:
    """Terminal name of a call: ``time.sleep(...)`` → ``"sleep"``,
    ``predict_file(...)`` → ``"predict_file"``."""
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def fstring_prefix(node: ast.AST) -> Optional[str]:
    """Literal prefix of an f-string (``f"step.{n}"`` → ``"step."``) —
    how dynamic metric/fault names are matched against registries."""
    if not isinstance(node, ast.JoinedStr) or not node.values:
        return None
    first = node.values[0]
    if isinstance(first, ast.Constant) and isinstance(first.value, str):
        return first.value
    return None


def module_str_constants(pf: ParsedFile) -> Dict[str, str]:
    """Module-level ``NAME = "literal"`` bindings (resolves e.g.
    ``registry.gauge(DRIFT_GAUGE)``)."""
    out: Dict[str, str] = {}
    if pf.tree is None:
        return out
    for node in pf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            value = const_str(node.value)
            if isinstance(target, ast.Name) and value is not None:
                out[target.id] = value
    return out
