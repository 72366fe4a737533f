"""The port's static-analysis engine (``memvul_tpu_torch/analysis/``)
against the JAX package's (``memvul_tpu/analysis/``), on the CPU.

* **parity**: for every language-neutral code (MV001, MV101–103, MV301–303,
  MV401–404) both engines run over the same fixture trees (the JAX tests'
  known-bad fixtures, one tree per code plus the checker-specific trees
  below) and must give the same ``(code, path, line)`` findings;
* **the re-rooted checkers**: MV201 (forward purity: ``nn.Module``
  methods, ``autograd.Function`` forward/backward, functions passed to
  ``checkpoint``; host syncs ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.synchronize()``) and MV405 (``nvcc`` or
  ``cpp_extension.load`` outside ``ops/_kernels.py``) on fixtures of their
  own, and the eager-PyTorch syncs MV102 and MV301 add;
* **engine semantics**: suppressions, the baseline and its stale entries,
  ``--select``, one parse per file;
* **the gate**: ``analyze_repo()`` over ``memvul_tpu_torch/`` has no active
  finding and no stale baseline entry, every inline suppression carries a
  justification, the fault registry covers every call site and test spec;
* **the CLI** (exit codes, the ``--json`` schema) and ``BENCH_LINT=1``'s
  record.
"""

import ast
import json
import re
from pathlib import Path

import pytest

import test_static_analysis as jax_sa  # the JAX package's fixtures

from memvul_tpu.analysis import analyze as jax_analyze
from memvul_tpu_torch.analysis import (
    BASELINE_PATH,
    CHECKERS,
    analyze,
    analyze_repo,
    baseline_document,
    load_baseline,
    run_tool_checkers,
)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "memvul_tpu_torch"

NEUTRAL_CODES = ("MV001", "MV101", "MV102", "MV103", "MV301", "MV302", "MV303",
                 "MV401", "MV402", "MV403", "MV404")
RE_ROOTED_CODES = ("MV201", "MV405")

# the JAX tests' checker-specific trees (beyond one fixture per code)
EXTRA_TREES = {
    "lock_cond_wait": {
        "pkg/c.py": (
            "import threading\n"
            "class S:\n"
            "    def __init__(self):\n"
            "        self._cond = threading.Condition()\n"
            "        self._thread = threading.Thread(target=self._loop)\n"
            "    def _loop(self):\n"
            "        with self._cond:\n"
            "            self._cond.wait(0.05)\n"
        ),
    },
    "shared_attr_locked": {
        "pkg/ok.py": (
            "import threading\n"
            "class Worker:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self._thread = threading.Thread(target=self._loop)\n"
            "    def _loop(self):\n"
            "        with self._lock:\n"
            "            self.state = 'running'\n"
            "    def stop(self):\n"
            "        with self._lock:\n"
            "            self.state = 'stopped'\n"
        ),
    },
    "fault_specs_in_tests": dict(
        jax_sa.FIXTURES["MV401"]["files"],
        **{"tests/test_chaos.py": (
            f'SPEC = "{jax_sa._BAD_SPEC}"\n'
            'OK = "serve.batch=sigterm"\n'
            'UNIT = "a=raise"  # dotless parser fixture, never a registry member\n'
        )},
    ),
    "fault_prefixes": {
        "pkg/resilience/faults.py": jax_sa._FAULTS_PY,
        "pkg/fp.py": (
            "from .resilience.faults import fault_point\n"
            "def f(n):\n"
            '    fault_point(f"step.{n}")\n'
        ),
    },
    "metric_placeholders": {
        "pkg/emit.py": (
            "def f(tel, label):\n"
            '    tel.counter(f"x.wins.{label}").inc()\n'
        ),
        "docs/metrics.md": (
            "| metric | kind |\n|---|---|\n"
            "| `x.wins.<id>` | counter |\n"
            "| `x.rate` | derived |\n"
        ),
    },
    "config_get_calls": dict(
        jax_sa.FIXTURES["MV404"]["files"],
        **{"pkg/use2.py": (
            "from .config import foo_config\n"
            "cfg = foo_config({})\n"
            'x = cfg.get("known")\n'
            'y = cfg.get("also_typo")\n'
        )},
    ),
    "endpoints_and_dispatchers": {
        "pkg/bad_endpoints.py": (
            "from http.server import BaseHTTPRequestHandler\n"
            "class MetricsHandler(BaseHTTPRequestHandler):\n"
            "    def do_GET(self):\n"
            "        if self.path == '/metrics':\n"
            "            self.server.service.predict_file('corpus')\n"
            "        elif self.path == '/tracez':\n"
            "            pack_token_budget([1, 2], 8, 4)\n"
            "    def do_POST(self):\n"
            "        rolling_swap(self.server.router, [])\n"
        ),
        "pkg/bad_dispatch.py": (
            "import time\n"
            "class Dispatcher:\n"
            "    def run(self):\n"
            "        time.sleep(0.1)\n"
            "class EagerDispatcher(Dispatcher):\n"
            "    def _admit(self, request):\n"
            "        self.predictor.score_texts([request.text])\n"
            "    def _flush(self):\n"
            "        self.predictor.predict_file('corpus')\n"
        ),
        "pkg/good_dispatch.py": (
            "class ContinuousDispatcher:\n"
            "    def _admit(self, request):\n"
            "        seq = self.encoder.encode_many([request.text])[0]\n"
            "        pack_token_budget([len(seq)], 96, 4)\n"
            "        sample = collate_ragged([seq], 96, 4, 0)\n"
            "        return self.predictor._ragged_score_fn(\n"
            "            self.params, sample, self.bank)\n"
        ),
        "pkg/bad_fleet.py": (
            "import time\n"
            "class HostBalancer:\n"
            "    def _pick(self, hosts):\n"
            "        time.sleep(0.1)\n"
            "        return hosts[0].service.score_texts(['probe'])\n"
            "class Autoscaler:\n"
            "    def tick(self):\n"
            "        self.replica.service.install_bank(self.bank, [], 2)\n"
        ),
        "pkg/bad_cache.py": (
            "import time\n"
            "class AdmissionCache:\n"
            "    def lookup(self, key):\n"
            "        time.sleep(0.1)\n"
            "        return self.predictor.encode_bank([key])\n"
            "class TenantManager:\n"
            "    def resolve(self, name):\n"
            "        return self.fleet.rolling_swap(name)\n"
            "class IncidentRecorder:\n"
            "    def trigger(self, kind):\n"
            "        self.service.predictor.pack_token_budget([1], 8, 4)\n"
        ),
    },
}


def _write_tree(root, files):
    for rel, content in files.items():
        if isinstance(content, tuple):
            content = "".join(content)
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(content)
    return root


def _run(engine, root, select=None, baseline=None):
    return engine(root / "pkg", base_dir=root, docs_dir=root / "docs",
                  tests_dir=root / "tests", select=select, baseline=baseline)


def _hits(result):
    return sorted((f.code, f.path, f.line) for f in result.active)


# -- parity with the JAX engine on the language-neutral codes --------------------

@pytest.mark.parametrize("code", NEUTRAL_CODES)
def test_neutral_checker_matches_jax_on_its_fixture(tmp_path, code):
    fx = jax_sa.FIXTURES[code]
    _write_tree(tmp_path, fx["files"])
    ours = _run(analyze, tmp_path, select=[code])
    theirs = _run(jax_analyze, tmp_path, select=[code])
    assert _hits(ours) == _hits(theirs)
    assert (code, *fx["target"]) in _hits(ours)


@pytest.mark.parametrize("tree", sorted(EXTRA_TREES))
def test_neutral_checkers_match_jax_on_specific_trees(tmp_path, tree):
    _write_tree(tmp_path, EXTRA_TREES[tree])
    ours = _run(analyze, tmp_path, select=list(NEUTRAL_CODES))
    theirs = _run(jax_analyze, tmp_path, select=list(NEUTRAL_CODES))
    assert _hits(ours) == _hits(theirs)


def test_all_fixtures_together_match_jax_on_neutral_codes(tmp_path):
    files = {}
    for fx in jax_sa.FIXTURES.values():
        files.update(fx["files"])
    _write_tree(tmp_path, files)
    ours = _run(analyze, tmp_path, select=list(NEUTRAL_CODES))
    theirs = _run(jax_analyze, tmp_path, select=list(NEUTRAL_CODES))
    assert _hits(ours) == _hits(theirs)
    # MV101's pkg/bad.py replaces MV001's, MV403's emit.py and docs MV402's
    assert {code for code, _, _ in _hits(ours)} == set(NEUTRAL_CODES) - {"MV001", "MV402"}


# -- the re-rooted checkers: MV201 (forward purity), MV405 (kernel builds) -------

PORT_FIXTURES = {
    "MV201": {
        "files": {
            "pkg/model.py": (
                "import torch\n"
                "from torch import nn\n"
                "def helper(x):\n"
                "    return x.sum().item()\n"
                "class Encoder(nn.Module):\n"
                "    def __init__(self, width):\n"
                "        super().__init__()\n"
                "        self.width = int(width)  # construction, not a forward\n"
                "    def forward(self, x):\n"
                "        n = helper(x)\n"
                "        return x * n\n"
                "def host_only(x):\n"
                "    return x.cpu().tolist()  # no forward reaches it: not flagged\n"
            ),
        },
        "target": ("pkg/model.py", 4),
        "hits": [("pkg/model.py", 4, ".item")],
    },
    "MV405": {
        "files": {
            "pkg/build_extra.py": (
                "import subprocess\n"
                "def build(src):\n"
                "    subprocess.run(['nvcc', '-c', src], check=True)\n"
            ),
            "pkg/jit_ext.py": (
                "from torch.utils import cpp_extension\n"
                "from torch.utils.cpp_extension import load_inline\n"
                "def ext(src):\n"
                "    a = cpp_extension.load(name='x', sources=[src])\n"
                "    return a, load_inline(name='y', cpp_sources=[src])\n"
            ),
            # the chokepoint itself is the one sanctioned build site
            "pkg/ops/_kernels.py": (
                "import subprocess\n"
                "def find_nvcc():\n"
                "    return '/usr/local/cuda/bin/nvcc'\n"
                "def build(src):\n"
                "    subprocess.run([find_nvcc(), '-c', src], check=True)\n"
            ),
        },
        "target": ("pkg/build_extra.py", 3),
        "hits": [("pkg/build_extra.py", 3, "nvcc"), ("pkg/jit_ext.py", 4, "cpp_extension.load"),
                 ("pkg/jit_ext.py", 5, "cpp_extension.load")],
    },
}


@pytest.mark.parametrize("code", RE_ROOTED_CODES)
def test_re_rooted_checker_fires_on_its_fixture(tmp_path, code):
    fx = PORT_FIXTURES[code]
    _write_tree(tmp_path, fx["files"])
    result = _run(analyze, tmp_path, select=[code])
    assert sorted((f.path, f.line, f.symbol) for f in result.active) == fx["hits"]


def test_purity_roots_autograd_functions_and_checkpointed_functions(tmp_path):
    _write_tree(tmp_path, {
        "pkg/fn.py": (
            "import time\n"
            "import torch\n"
            "from torch.utils.checkpoint import checkpoint\n"
            "class Flash(torch.autograd.Function):\n"
            "    @staticmethod\n"
            "    def forward(ctx, q):\n"
            "        torch.cuda.synchronize()\n"
            "        return q\n"
            "    @staticmethod\n"
            "    def backward(ctx, g):\n"
            "        return g.numpy()\n"
            "    @staticmethod\n"
            "    def describe():\n"
            "        return time.time()  # not forward/backward: not a root\n"
            "def run_layer(h):\n"
            "    print(h)\n"
            "    return h\n"
            "def step(h):\n"
            "    return checkpoint(run_layer, h, use_reentrant=False)\n"
        ),
        "pkg/derived.py": (
            "from torch import nn\n"
            "class Base(nn.Module):\n"
            "    pass\n"
            "class Child(Base):\n"
            "    def pooled(self, x):\n"
            "        return float(x)\n"
        ),
    })
    result = _run(analyze, tmp_path, select=["MV201"])
    assert sorted((f.path, f.line, f.symbol) for f in result.active) == [
        ("pkg/derived.py", 6, "float"),
        ("pkg/fn.py", 7, ".synchronize"),
        ("pkg/fn.py", 11, ".numpy"),
        ("pkg/fn.py", 16, "print"),
    ]


def test_purity_flags_host_to_device_constructors(tmp_path):
    """A constant copied to the card inside a forward (the plain attention's
    old ``torch.sqrt(torch.tensor(depth, ..., device=...))``) waits for the
    card; on the host, or filled on the device, it does not."""
    _write_tree(tmp_path, {
        "pkg/attn.py": (
            "import torch\n"
            "from torch import nn\n"
            "def scale(scores, query):\n"
            "    depth = query.shape[-1]\n"
            "    return scores / torch.sqrt(\n"
            "        torch.tensor(depth, dtype=query.dtype, device=query.device)\n"
            "    )\n"
            "def shift(x):\n"
            "    return x + torch.as_tensor([1.0, 2.0], device=x.device)\n"
            "def host_and_filled(x):\n"
            "    d = float(torch.sqrt(torch.tensor(x.shape[-1], dtype=x.dtype)))\n"
            "    return x / torch.full((), d, dtype=x.dtype, device=x.device)\n"
            "class Attention(nn.Module):\n"
            "    def forward(self, q):\n"
            "        return host_and_filled(shift(scale(q, q)))\n"
            "def never_in_a_forward(x):\n"
            "    return torch.tensor(1.0, device=x.device)\n"
        ),
    })
    result = _run(analyze, tmp_path, select=["MV201"])
    assert sorted((f.path, f.line, f.symbol) for f in result.active) == [
        ("pkg/attn.py", 6, "torch.tensor"),
        ("pkg/attn.py", 9, "torch.as_tensor"),
    ]


def test_eager_syncs_block_handlers_and_lock_holders(tmp_path):
    """MV102 and MV301 count eager PyTorch's device→host syncs as blocking;
    the JAX engine, whose names they add to, does not see these."""
    _write_tree(tmp_path, {
        "pkg/h.py": (
            "import torch\n"
            "from http.server import BaseHTTPRequestHandler\n"
            "class H(BaseHTTPRequestHandler):\n"
            "    def do_GET(self):\n"
            "        torch.cuda.synchronize()\n"
            "        return self.server.scores.cpu().tolist()\n"
            "class ContinuousDispatcher:\n"
            "    def _admit(self, request):\n"
            "        self.stream.synchronize()\n"
        ),
        "pkg/lk.py": (
            "import threading\n"
            "class Service:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self._thread = threading.Thread(target=self._loop)\n"
            "    def _loop(self):\n"
            "        pass\n"
            "    def snapshot(self, t):\n"
            "        with self._lock:\n"
            "            return t.item()\n"
        ),
    })
    ours = _run(analyze, tmp_path, select=["MV102", "MV301"])
    assert sorted((f.code, f.line, f.symbol) for f in ours.active) == [
        ("MV102", 5, "synchronize"), ("MV102", 6, "cpu"), ("MV102", 6, "tolist"),
        ("MV102", 9, "synchronize"), ("MV301", 10, "item"),
    ]
    assert _run(jax_analyze, tmp_path, select=["MV102", "MV301"]).active == []


# -- engine semantics -------------------------------------------------------------

ALL_FIXTURES = dict(jax_sa.FIXTURES, **PORT_FIXTURES)


@pytest.mark.parametrize(
    "code", [c for c in sorted(ALL_FIXTURES) if ALL_FIXTURES[c].get("suppressible", True)],
)
def test_inline_suppression_and_its_deletion(tmp_path, code):
    fx = ALL_FIXTURES[code]
    _write_tree(tmp_path, fx["files"])
    rel, line = fx["target"]
    target = tmp_path / rel
    original = target.read_text()
    lines = original.splitlines()
    lines[line - 1] += f"  # lint: disable={code}"
    target.write_text("\n".join(lines) + "\n")
    result = _run(analyze, tmp_path)
    assert not [f for f in result.active if f.code == code and (f.path, f.line) == (rel, line)]
    assert [f for f in result.suppressed if f.code == code]
    target.write_text(original)
    result = _run(analyze, tmp_path)
    assert [f for f in result.active if f.code == code]


def test_suppression_all_wildcard(tmp_path):
    _write_tree(tmp_path, {"pkg/bad.py": "def f():\n    print('x')  # lint: disable=all\n"})
    result = _run(analyze, tmp_path)
    assert not result.active and len(result.suppressed) == 1


def test_baseline_semantics_and_stale_entries(tmp_path):
    _write_tree(tmp_path, dict(jax_sa.FIXTURES["MV101"]["files"]))
    first = _run(analyze, tmp_path)
    assert len(first.active) == 1
    assert load_baseline(None) == []
    baseline_file = tmp_path / "baseline.json"
    baseline_file.write_text(baseline_document(first.active))
    entries = load_baseline(baseline_file)
    second = _run(analyze, tmp_path, baseline=entries)
    assert second.active == [] and len(second.baselined) == 1
    assert len(_run(analyze, tmp_path, baseline=[]).active) == 1
    stale_entry = dict(entries[0], path="pkg/gone.py")
    fourth = _run(analyze, tmp_path, baseline=entries + [stale_entry])
    assert fourth.stale_baseline == [stale_entry]


def test_select_runs_only_requested_codes(tmp_path):
    files = dict(jax_sa.FIXTURES["MV101"]["files"])
    files.update(jax_sa.FIXTURES["MV103"]["files"])
    _write_tree(tmp_path, files)
    assert {f.code for f in _run(analyze, tmp_path, select=["MV103"]).active} == {"MV103"}
    with pytest.raises(ValueError):
        _run(analyze, tmp_path, select=["MV999"])
    assert {f.code for f in run_tool_checkers(["MV001", "MV101"], tmp_path / "pkg").active} == {
        "MV101"}


def test_engine_parses_each_file_exactly_once(tmp_path, monkeypatch):
    files = {}
    for fx in ALL_FIXTURES.values():
        files.update(fx["files"])
    _write_tree(tmp_path, files)
    calls = []
    real_parse = ast.parse
    monkeypatch.setattr(ast, "parse", lambda *a, **k: calls.append(a) or real_parse(*a, **k))
    result = _run(analyze, tmp_path)
    n_py = len(list((tmp_path / "pkg").rglob("*.py")))
    assert result.parse_count == n_py == len(calls)


def test_checker_catalog_has_every_code():
    assert sorted(CHECKERS) == ["MV101", "MV102", "MV103", "MV201", "MV301", "MV302", "MV303",
                                "MV401", "MV402", "MV403", "MV404", "MV405"]


# -- the gate: the port's tree is clean -----------------------------------------

@pytest.fixture(scope="module")
def repo_result():
    return analyze_repo()


def test_engine_clean_on_the_port(repo_result):
    assert [f"{f.path}:{f.line}: {f.code} {f.message}" for f in repo_result.active] == []
    py_files = [p for p in PORT.rglob("*.py") if "__pycache__" not in p.parts]
    assert repo_result.parse_count == len(py_files)
    assert repo_result.elapsed_s < 60.0


def test_committed_baseline_is_empty_and_not_stale(repo_result):
    assert load_baseline(BASELINE_PATH) == []
    assert repo_result.stale_baseline == [] and repo_result.baselined == []


def test_port_suppressions_carry_justifications(repo_result):
    """Every ``# lint: disable=`` line in the port has a comment line right
    above it (the why), and every one of them silences a real finding."""
    sites = 0
    for path in PORT.rglob("*.py"):
        if "__pycache__" in path.parts:
            continue
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            if "# lint: disable=" in line and not line.lstrip().startswith("#"):
                sites += 1
                above = lines[i - 1].lstrip() if i else ""
                assert above.startswith("#"), f"{path.name}:{i + 1} has no justification above"
    assert sites == len(repo_result.suppressed) > 0


def test_registered_fault_points_match_real_call_sites():
    """The port's machine-readable fault registry covers every
    ``fault_point(...)`` call site and every point a ``tests/test_torch_*``
    ``MEMVUL_FAULTS`` spec names, and each registered point has a site."""
    from memvul_tpu_torch.resilience import faults

    def registered(name):
        return name in faults.REGISTERED_POINTS or name.startswith(
            faults.REGISTERED_POINT_PREFIXES)

    sites, prefixes = set(), set()
    for path in PORT.rglob("*.py"):
        if "analysis" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                    node.func, "id", "")) == "fault_point" and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant):
                    sites.add(arg.value)
                elif isinstance(arg, ast.JoinedStr):
                    prefixes.add(arg.values[0].value)
    assert sites and all(registered(s) for s in sites), sorted(sites)
    assert set(prefixes) <= set(faults.REGISTERED_POINT_PREFIXES), prefixes
    spec = re.compile(r"([A-Za-z_][\w-]*(?:\.[\w.-]+)+)(?:@\d+)?=(?:raise|sigterm|sigint|sigkill)\b")
    named = {m.group(1) for path in (REPO / "tests").glob("test_torch_*.py")
             for m in spec.finditer(path.read_text())}
    assert named and all(registered(n) for n in named), sorted(n for n in named
                                                             if not registered(n))
    # every registered point has a real site (serve.batch and serve.cascade
    # are named through the dispatcher's variable)
    dispatch = (PORT / "serving" / "dispatch.py").read_text()
    for point in faults.REGISTERED_POINTS:
        assert point in sites or f'"{point}"' in dispatch, point
    assert "kernel.lower" not in faults.REGISTERED_POINTS


def test_metric_catalog_reconciled_both_ways(repo_result):
    assert [f for f in repo_result.active if f.code in ("MV402", "MV403")] == []
    from memvul_tpu_torch.analysis import DOCS_DIR

    rows = [line for line in (DOCS_DIR / "observability.md").read_text().splitlines()
            if line.startswith("| `")]
    assert len(rows) > 60


# -- CLI and bench ----------------------------------------------------------------

def test_lint_cli_exits_zero_on_the_port(capsys):
    from memvul_tpu_torch.__main__ import main

    assert main(["lint"]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s)" in out and "parsed once" in out


def test_lint_cli_json_schema_matches_jax(tmp_path, capsys):
    from memvul_tpu.__main__ import main as jax_main
    from memvul_tpu_torch.__main__ import main

    _write_tree(tmp_path, dict(jax_sa.FIXTURES["MV101"]["files"]))
    argv = ["lint", "--root", str(tmp_path / "pkg"), "--json", "--no-baseline"]
    assert main(argv) == 1
    doc = json.loads(capsys.readouterr().out)
    assert jax_main(argv) == 1
    theirs = json.loads(capsys.readouterr().out)
    assert set(doc) == set(theirs) == {
        "version", "findings", "counts", "stale_baseline", "files", "codes", "elapsed_s"}
    assert set(doc["counts"]) == set(theirs["counts"])
    (finding,) = doc["findings"]
    assert set(finding) == {"code", "path", "line", "message", "symbol"}
    assert (finding["code"], finding["path"], finding["line"]) == (
        theirs["findings"][0]["code"], theirs["findings"][0]["path"],
        theirs["findings"][0]["line"])
    assert doc["counts"]["by_code"] == {"MV101": 1}


def test_lint_cli_select_usage_errors_and_baseline_roundtrip(tmp_path, capsys):
    from memvul_tpu_torch.__main__ import main

    files = dict(jax_sa.FIXTURES["MV101"]["files"])
    files.update(jax_sa.FIXTURES["MV103"]["files"])
    _write_tree(tmp_path, files)
    root = str(tmp_path / "pkg")
    assert main(["lint", "--root", root, "--select", "MV103", "--json", "--no-baseline"]) == 1
    assert {f["code"] for f in json.loads(capsys.readouterr().out)["findings"]} == {"MV103"}
    assert main(["lint", "--root", root, "--select", "MV999"]) == 2
    assert main(["lint", "--root", str(tmp_path / "missing")]) == 2
    baseline = tmp_path / "bl.json"
    assert main(["lint", "--root", root, "--baseline", str(baseline), "--write-baseline"]) == 0
    assert main(["lint", "--root", root, "--baseline", str(baseline)]) == 0
    assert main(["lint", "--root", root, "--no-baseline"]) == 1
    capsys.readouterr()
    assert main(["lint", "--list-codes"]) == 0
    out = capsys.readouterr().out
    assert all(code in out for code in list(CHECKERS) + ["MV001"])


def test_bench_lint_record_is_parseable():
    from memvul_tpu_torch.bench import _lint_record

    record = json.loads(json.dumps(_lint_record()))
    assert record["metric"] == "lint"
    assert record["clean"] is True and record["findings"] == []
    assert set(record) == {"metric", "clean", "findings", "suppressed", "baselined", "files",
                           "elapsed_s"}
    assert record["suppressed"] > 0 and record["files"] > 100
