"""Static analysis of the port's own sources (the JAX package's
``analysis/``).

One ``ast`` parse per file shared by all registered checkers; findings as
structured ``{code, path, line, message}`` records; inline ``lint:
disable=CODE`` comment suppressions plus a committed baseline
(``analysis/baseline.json``); ``python -m memvul_tpu_torch lint
[--select CODE,...] [--json]``.

:func:`analyze_repo` runs over ``memvul_tpu_torch/`` with the port's own
corpora: the tests are ``tests/test_torch_*.py`` (the JAX package's tests
name fault points the port does not register, such as ``kernel.lower``)
and the docs are the port's metric catalog, ``memvul_tpu_torch/docs/``
(``docs/`` is the JAX package's and names its metrics, such as
``xla.*``).  :func:`run_tool_checkers` is the one-family API the JAX
package's ``tools/lint_*.py`` shims call; the port has no such shims.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Optional

from .engine import (  # noqa: F401
    CHECKERS,
    AnalysisResult,
    Finding,
    analyze,
    baseline_document,
    load_baseline,
    register,
)
from . import checkers  # noqa: F401  (registers every checker family)

PACKAGE_ROOT = Path(__file__).resolve().parents[1]
REPO_ROOT = PACKAGE_ROOT.parent
BASELINE_PATH = Path(__file__).resolve().parent / "baseline.json"
DOCS_DIR = PACKAGE_ROOT / "docs"
TESTS_GLOB = "test_torch_*.py"


def analyze_repo(
    select: Optional[Iterable[str]] = None,
    baseline_path: Optional[Path] = BASELINE_PATH,
) -> AnalysisResult:
    """Run the engine over the port's tree with the committed baseline:
    what the CLI, the gate test and ``BENCH_LINT=1`` call."""
    return analyze(
        PACKAGE_ROOT,
        base_dir=REPO_ROOT,
        docs_dir=DOCS_DIR,
        tests_dir=REPO_ROOT / "tests",
        tests_glob=TESTS_GLOB,
        select=list(select) if select is not None else None,
        baseline=load_baseline(baseline_path),
    )


def run_tool_checkers(codes: Iterable[str], root: Path) -> AnalysisResult:
    """An engine run scoped as one checker family over an arbitrary
    directory: paths relative to that directory, no baseline."""
    root = Path(root)
    return analyze(root, base_dir=root, select=list(codes))
