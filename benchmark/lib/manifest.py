"""Everything the harness knows of a cell, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix.  The files:

* ``benchmark/configs/<config>.json`` — the configuration as it is run, with
  the name of its plain reference (``benchmark/reference/<reference>.py``);
* ``benchmark/traffic/<mix>.json`` — the mix's parameters for the general
  generator, with the name of the entry that drives it
  (``benchmark/entries/<entry>.py``);
* ``benchmark/cells/<cell>.json`` — the cell's own numbers: the limits of
  its comparison and the size of its sample;
* ``benchmark/metrics/<metric>.py`` — one reader per metric, ``read(run)``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"


def load_json(path: Path) -> Dict:
    return json.loads(Path(path).read_text())


def manifest() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def by_name(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(name: str) -> Dict:
    return by_name(manifest()["workloads"], name, "workload")


def config(name: str) -> Dict:
    entry = by_name(manifest()["configs"], name, "configuration")
    return load_json(ROOT / entry["file"])


def traffic(name: str) -> Dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def cell(name: str) -> Dict:
    return load_json(HERE / "cells" / f"{name}.json")


def entry(name: str):
    return importlib.import_module(f"benchmark.entries.{name}")


def reference(name: str):
    return importlib.import_module(f"benchmark.reference.{name}")


def metrics_for(cell_name: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell_name`` reports: the end-to-end ones
    without a trace, the per-layer ones with it."""
    m = manifest()
    listed = m["per_layer"] if trace else m["end_to_end"]
    return [x for x in listed if cell_name in x.get("workloads", [cell_name])]


def reader(metric: str):
    """The module of ``benchmark/metrics/<metric>.py`` (names may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
