"""BENCHMARK.json against the benchmark's contract, and every file it names."""

import json
import re

import pytest

from benchmark.lib import manifest

M = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head).*|.*(_dim|_rank|_size)$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(M) == KEYS["top"]
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in M[section]:
            extra = set(e) - KEYS[section] - ({"workloads"} if section in ("end_to_end", "per_layer") else set())
            assert set(e) >= KEYS[section] and not extra, (section, e["name"])
    assert 1 <= len(M["configs"]) <= 24 and 1 <= len(M["workloads"]) <= 24
    assert 1 <= len(M["end_to_end"]) <= 16 and 1 <= len(M["per_layer"]) <= 128


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_lines(section):
    names = [e["name"] for e in M[section]]
    assert len(set(names)) == len(names)
    for e in M[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)
        if section == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"]) and e["chips"] in (1, 4)
        if section == "configs":
            assert len(e["reduced"]) <= 16 and all(NAME.match(k) for k in e["reduced"])
            assert not any(WIDTHS.match(k) for k in e["reduced"]), e["reduced"]


def test_command_paths_and_window():
    assert M["paths"] == ["benchmark"] and all(re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) for p in M["paths"])
    assert 1 <= len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    assert not any(w.startswith("/") or ".." in w for w in M["command"])
    assert M["command"][1].startswith("benchmark/")
    rs = M["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells: 2 + 14 runs a cell at run_seconds + 60 s,
    # 2 x 90 s of compile a cell, 1200 s spare, within 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    layers = {}
    for m in M["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(_line(k) for k in layers)


def test_every_cell_reports_enough_and_every_config_is_used():
    for w in M["workloads"]:
        e2e = [m["name"] for m in manifest.metrics_for(w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_for(w["name"], True)
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)
    fours = sum(w["chips"] == 4 for w in M["workloads"])
    assert fours <= max(1, len(M["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_files_of_each_cell(cell):
    w = manifest.workload(cell)
    cfg = manifest.config(w["config"])
    mix = manifest.traffic(w["traffic"])
    limits = manifest.cell(cell)
    assert limits["sample"] >= 32 and limits["limits"]["answer_mse"] > 0
    assert (manifest.HERE / "entries" / f"{mix['entry']}.py").is_file()
    assert (manifest.HERE / "reference" / f"{cfg['reference']}.py").is_file()
    for m in manifest.metrics_for(cell, False) + manifest.metrics_for(cell, True):
        assert callable(manifest.reader(m["name"]).read)
    entry = next(c for c in M["configs"] if c["name"] == w["config"])
    assert entry["file"].startswith("benchmark/configs/")
    for key in ("hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
                "vocab_size", "max_position_embeddings"):
        assert isinstance(cfg[key], int)
    assert (cfg["hidden_size"], cfg["num_hidden_layers"], cfg["num_attention_heads"],
            cfg["intermediate_size"], cfg["vocab_size"]) == (768, 12, 12, 3072, 30522)
    json.dumps(cfg)
