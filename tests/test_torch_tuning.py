"""The port's autotuner (``memvul_tpu_torch/tuning/``) against the JAX
package's (``memvul_tpu/tuning/``), on the CPU.

* the knob space: ``train_space`` and ``serve_space`` equal, candidate for
  candidate, over the default and other grids;
* analytic pruning: step-shape counts and decisions equal on the same
  registry rows and peak row (the port's ``PEAK_SPECS`` H100 row);
* the parity gate: verdicts equal on the same arrays and trajectories
  (bitwise serving, ``LOSS_TOL`` training, the same refusal codes);
* ``choose_band`` and ``roofline_markdown`` / ``splice_generated_section``
  equal on the same inputs;
* tuned profiles: a store written by either package loads in the other,
  with equal overlays; the manifest's checksum, versions and warnings;
  the device class of the H100 and the unknown-class refusal (``tune`` exit
  2); a CUDA ``run_tune`` on a host without one raises;
* the build: ``train_from_config`` and ``serve_from_archive`` read the
  tuned knobs where the config leaves them unset and keep the explicit
  ones; with no profile root the sections pass through unchanged;
* ``tune --report`` / ``--splice`` through the CLI.
(``run_tune``'s record against the JAX package's is in
``test_torch_bench.py``, beside the tune micro that shares its run.)
"""

import importlib
import json
import logging

import numpy as np
import pytest

from memvul_tpu.tuning import cascade as jax_cascade
from memvul_tpu.tuning import knobs as jax_knobs
from memvul_tpu.tuning import parity as jax_parity
from memvul_tpu.tuning import profile as jax_profile
from memvul_tpu.tuning import prune as jax_prune
from memvul_tpu.tuning import report as jax_report
from memvul_tpu_torch.tuning import cascade, knobs, parity, profile, prune, report

PROFILE_LOGGER = "memvul_tpu_torch.tuning.profile"


def _names(cands):
    return [(c.kind, c.name, c.knobs) for c in cands]


@pytest.mark.parametrize("kwargs", [
    {}, {"max_length": 128, "batch_size": 8},
    {"bucket_grids": [None, "pow2"], "dedup_options": (True,), "prefetch_depths": (2, 8)},
    {"max_length": 256, "bucket_grids": [[64, 256], "pow2"], "dedup_options": (True, False)},
])
def test_train_space_equals_the_jax_package(kwargs):
    assert _names(knobs.train_space(**kwargs)) == _names(jax_knobs.train_space(**kwargs))


@pytest.mark.parametrize("kwargs", [
    {}, {"max_length": 128, "max_batch": 8},
    {"wait_ms_options": (2.0, 5.0), "budget_factors": (2, 4), "rows_factors": (1,)},
    {"impls": ("continuous",), "budget_factors": (1, 8), "rows_factors": (1, 2, 4)},
])
def test_serve_space_equals_the_jax_package(kwargs):
    assert _names(knobs.serve_space(**kwargs)) == _names(jax_knobs.serve_space(**kwargs))
    with pytest.raises(ValueError, match="unknown impl"):
        knobs.serve_space(impls=("bucketed", "flash"))


class _StubRegistry:
    def __init__(self, rows):
        self._rows = rows

    def snapshot(self):
        return list(self._rows)


@pytest.mark.parametrize("grid,dedup,batch,length", [
    (None, True, 32, 512), ([64, 128, 256, 512], False, 32, 512),
    ([64, 128, 256, 512], True, 32, 512), ("pow2", True, 8, 128), ("pow2", True, 48, 384),
])
def test_estimate_train_programs_equals_the_jax_package(grid, dedup, batch, length):
    assert prune.estimate_train_programs(grid, dedup, batch, length) \
        == jax_prune.estimate_train_programs(grid, dedup, batch, length)


@pytest.mark.parametrize("rows,peak,max_programs", [
    ([], None, 64),
    ([], {"hbm_bytes": 80e9}, 64),
    ([{"key": "score:16x512", "hbm_bytes": 50e9}, {"key": "bank", "hbm_bytes": 1e9}],
     {"hbm_bytes": 80e9}, 4),
    ([{"key": "serve_step", "hbm_bytes": 10e9}], {"hbm_bytes": 16e9}, 64),
])
def test_prune_decisions_equal_the_jax_package(rows, peak, max_programs):
    cands = (knobs.train_space(max_length=512, batch_size=32)
             + knobs.serve_space(max_length=512, max_batch=16, budget_factors=(2, 32)))
    jax_cands = (jax_knobs.train_space(max_length=512, batch_size=32)
                 + jax_knobs.serve_space(max_length=512, max_batch=16, budget_factors=(2, 32)))
    kw = dict(batch_size=32, max_length=512, max_batch=16, max_programs=max_programs,
              hbm_fraction=0.9, peak=peak, registry=_StubRegistry(rows))
    ours = [d.to_json() for d in prune.prune_candidates(cands, **kw)]
    theirs = [d.to_json() for d in jax_prune.prune_candidates(jax_cands, **kw)]
    assert ours == theirs
    assert [c.name for c in prune.survivors(prune.prune_candidates(cands, **kw))] == \
        [c.name for c in jax_prune.survivors(jax_prune.prune_candidates(jax_cands, **kw))]


def test_prune_reads_the_port_registry_memory():
    from memvul_tpu_torch.telemetry.programs import ProgramRegistry

    reg = ProgramRegistry()
    assert prune.measured_hbm_baseline(reg) is None
    reg.register("score:16x512", scope="score", argument_bytes=6 * 10**9,
                 temp_bytes=4 * 10**9)
    assert prune.measured_hbm_baseline(reg) == {"hbm_bytes": 10e9, "key": "score:16x512"}


SCORES = np.array([[0.25, 0.75], [0.9, 0.1]], dtype=np.float32)


@pytest.mark.parametrize("case", ["equal", "ulp", "shape", "far"])
def test_serve_parity_verdicts_equal_the_jax_package(case):
    base = SCORES
    cand = {"equal": SCORES.copy(),
            "ulp": SCORES + np.float32(1e-7) * np.eye(2, dtype=np.float32),
            "shape": np.zeros((3, 2), np.float32),
            "far": SCORES[::-1].copy()}[case]
    ours = parity.check_serve_parity(knobs.Candidate("serve", "s", {}), base, cand).to_json()
    theirs = jax_parity.check_serve_parity(jax_knobs.Candidate("serve", "s", {}), base,
                                           cand).to_json()
    assert ours == theirs
    assert ours["passed"] is (case == "equal")


@pytest.mark.parametrize("case", ["within", "diverged", "short", "empty"])
def test_train_parity_verdicts_equal_the_jax_package(case):
    assert parity.LOSS_TOL == jax_parity.LOSS_TOL == 1e-4
    base = [2.0, 1.5, 1.2, 1.0]
    cand = {"within": [x + parity.LOSS_TOL / 2 for x in base],
            "diverged": base[:-1] + [base[-1] + 10 * parity.LOSS_TOL],
            "short": base[:-1], "empty": []}[case]
    if case == "empty":
        base = []
    ours = parity.check_train_parity(knobs.Candidate("train", "t", {}), base, cand).to_json()
    theirs = jax_parity.check_train_parity(jax_knobs.Candidate("train", "t", {}), base,
                                           cand).to_json()
    assert ours == theirs
    code = {"within": None, "diverged": "parity_loss_divergence", "short": "parity_step_count",
            "empty": "parity_no_evidence"}[case]
    assert [r["code"] for r in ours["reasons"]] == ([code] if code else [])


@pytest.mark.parametrize("rate", [0.1, 0.3, 1.0])
def test_choose_band_equals_the_jax_package(rate, monkeypatch):
    scores = np.array([0.05, 0.1, 0.2, 0.45, 0.48, 0.52, 0.8, 0.9, 0.95, 0.99, 0.3, 0.61])

    class _FakePredictor:
        cascade_band = (0.3, 0.7)

        def score_texts(self, texts, impl=None):
            assert impl == "int8"
            return scores[:, None]

    class _Decision:
        approved = True

        def to_json(self):
            return {"approved": True}

    seen = {}

    def fake_evaluate(pred, insts, thresholds=None, threshold=0.5):
        seen.setdefault("bands", []).append(tuple(pred.cascade_band))
        return _Decision()

    for name in ("memvul_tpu.bankops.promote", "memvul_tpu_torch.bankops.promote"):
        monkeypatch.setattr(importlib.import_module(name), "evaluate_cascade", fake_evaluate)
    instances = [{"text1": f"t{i}"} for i in range(len(scores))]
    ours_pred, theirs_pred = _FakePredictor(), _FakePredictor()
    ours = cascade.choose_band(ours_pred, instances, target_rescore_rate=rate)
    theirs = jax_cascade.choose_band(theirs_pred, instances, target_rescore_rate=rate)
    assert ours == theirs
    assert seen["bands"][0] == seen["bands"][1]
    assert ours_pred.cascade_band == (0.3, 0.7)  # restored after the gate
    with pytest.raises(ValueError, match="non-empty"):
        cascade.choose_band(object(), [])
    with pytest.raises(ValueError, match="target_rescore_rate"):
        cascade.choose_band(object(), [{"text1": "x"}], target_rescore_rate=0.0)


SNAPSHOT = [
    {"key": "train_step:2x32x128,2x32x256", "invocations": 10, "flops": 2.5e12,
     "bytes_accessed": 3.2e9, "hbm_bytes": 1.1e9, "device_time_s": 1.25, "mfu": 0.31},
    {"key": "score:64x128", "invocations": 4, "flops": 1.0e9, "bytes_accessed": 2.0e6,
     "hbm_bytes": None, "device_time_s": 0.01, "mfu": None},
]
ROOFLINE = {
    "device_kind": "NVIDIA H100 80GB HBM3", "interpret_only": False,
    "peak_flops_per_s": 989e12, "peak_bytes_per_s": 3.35e12, "programs": 2,
    "flops_total": 2.5e12, "bytes_total": 3.2e9, "device_time_s": 1.26,
    "achieved_flops_per_s": 1.98e12, "achieved_bytes_per_s": 2.5e9, "mfu": 0.002,
    "membw_util": 0.0007,
}


def _port_rows(rows):
    """The port's names of the JAX package's rows: its "mfu", a utilization
    of the card's busy time, is the port's "busy_util"."""
    return {"busy_util" if k == "mfu" else k: v for k, v in rows.items()}


def _port_words(md):
    return (md.replace("| MFU |", "| busy util |").replace(" MFU ", " busy util ")
            .replace("the MFU/bandwidth", "the busy-util/bandwidth"))


@pytest.mark.parametrize("roof", [ROOFLINE, {"device_kind": "cpu", "interpret_only": True}])
def test_roofline_markdown_equals_the_jax_package(roof, tmp_path):
    snapshot, port_roof = [_port_rows(row) for row in SNAPSHOT], _port_rows(roof)
    md = report.roofline_markdown(snapshot, port_roof)
    assert md == _port_words(jax_report.roofline_markdown(SNAPSHOT, roof))
    assert "MFU" not in md and "mfu" not in md
    assert md.startswith(report.BEGIN_MARK) and md.rstrip().endswith(report.END_MARK)
    doc = f"# Roofline\n\nabove\n\n{report.BEGIN_MARK}\nOLD\n{report.END_MARK}\n\nbelow\n"
    for text in (doc, "# no fence\n"):
        assert report.splice_generated_section(text, md) \
            == jax_report.splice_generated_section(text, md)
    (tmp_path / "programs.json").write_text(json.dumps({"programs": snapshot,
                                                        "roofline": port_roof}))
    (tmp_path / "jax_programs.json").write_text(json.dumps({"programs": SNAPSHOT,
                                                            "roofline": roof}))
    assert report.report_from_programs_json(tmp_path / "programs.json") \
        == _port_words(jax_report.report_from_programs_json(tmp_path / "jax_programs.json"))


# -- tuned profiles --------------------------------------------------------------

TUNED = {"train": {"train_buckets": "pow2", "dedup_anchors": False, "prefetch_depth": 16,
                   "not_a_trainer_knob": 1},
         "serving": {"score_impl": "ragged", "max_batch": 4, "token_budget": 2048,
                     "cascade_low": 0.4, "cascade_high": 0.6}}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_profile_written_by_either_package_loads_in_the_other(writer, tmp_path):
    save = (profile if writer == "port" else jax_profile).save_profile
    doc = save(tmp_path, "NVIDIA H100 80GB HBM3", TUNED)
    assert doc.parent.name == "nvidia_h100_80gb_hbm3" and doc.name == "profile-0001.json"
    ours = profile.load_profile(tmp_path, "nvidia_h100_80gb_hbm3")
    theirs = jax_profile.load_profile(tmp_path, "nvidia_h100_80gb_hbm3")
    assert ours == theirs and ours["version"] == 1 and ours["schema"] == profile.PROFILE_SCHEMA
    config = {"tuning": {"profile_dir": str(tmp_path), "device_class": "nvidia_h100_80gb_hbm3"}}
    for trainer in ({}, {"train_buckets": None, "batch_size": 4}):
        assert profile.apply_tuned_trainer(dict(trainer), config) \
            == jax_profile.apply_tuned_trainer(dict(trainer), config)
    explicit = {"max_batch": 32, "score_impl": None}
    merged = {"score_impl": "bucketed", "max_batch": 32, "token_budget": None}
    ours = profile.apply_tuned_serving(dict(merged), explicit, config)
    assert ours == jax_profile.apply_tuned_serving(dict(merged), explicit, config)
    assert ours["max_batch"] == 32 and ours["score_impl"] == "ragged"
    assert ours["token_budget"] == 2048 and ours["cascade_low"] == 0.4
    # the next save advances the version; the manifest points at it
    assert profile.save_profile(tmp_path, "nvidia_h100_80gb_hbm3", {}).name == "profile-0002.json"
    assert jax_profile.load_profile(tmp_path, "nvidia_h100_80gb_hbm3")["version"] == 2


def test_profile_store_failures_fall_back_with_one_warning(tmp_path, caplog):
    profile._warned_paths.clear()
    doc = profile.save_profile(tmp_path, "cpu", {"train": {"prefetch_depth": 2}})
    doc.write_text(doc.read_text().replace("2", "9"))
    with caplog.at_level(logging.WARNING, logger=PROFILE_LOGGER):
        assert profile.load_profile(tmp_path, "cpu") is None
        assert profile.load_profile(tmp_path, "cpu") is None
    assert len([r for r in caplog.records if "sha256 mismatch" in r.getMessage()]) == 1
    # a torn manifest does not wedge the writer
    (tmp_path / "cpu" / "MANIFEST.json").write_text("{torn")
    assert profile.save_profile(tmp_path, "cpu", {"train": {}}).name == "profile-0002.json"
    assert profile.load_profile(tmp_path, "cpu")["version"] == 2
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=PROFILE_LOGGER):
        assert profile.load_profile(None, "cpu") is None
        assert profile.load_profile(tmp_path, "never_tuned") is None
    assert not caplog.records
    profile._warned_paths.clear()


def test_profile_root_and_device_class(monkeypatch, tmp_path):
    monkeypatch.delenv("MEMVUL_TUNED_PROFILES", raising=False)
    assert profile.profile_root(None) is None
    # no profile root: the sections pass through unchanged
    trainer, merged = {"batch_size": 4}, {"score_impl": "bucketed", "max_batch": 16}
    assert profile.apply_tuned_trainer(dict(trainer), {}) == trainer
    assert profile.apply_tuned_serving(dict(merged), {}, {}) == merged
    monkeypatch.setenv("MEMVUL_TUNED_PROFILES", str(tmp_path / "env"))
    assert profile.profile_root(None) == tmp_path / "env"
    assert profile.profile_root(tmp_path / "cfg") == tmp_path / "cfg"
    for kind in ("NVIDIA H100 80GB HBM3", "TPU v5 lite", "", "grace-hopper"):
        assert profile.normalize_device_class(kind) == jax_profile.normalize_device_class(kind)
    cls, peak = profile.resolve_device_class("NVIDIA H100 80GB HBM3")
    assert cls == "nvidia_h100_80gb_hbm3" and peak["hbm_bytes"] == 80e9
    assert profile.resolve_device_class("tpu_v9") == ("tpu_v9", None)
    assert profile.resolve_device_class(device="cpu") == ("cpu", None)
    config = {"tuning": {"profile_dir": str(tmp_path), "device_class": "cpu", "enabled": False}}
    profile.save_profile(tmp_path, "cpu", {"train": {"prefetch_depth": 16}})
    assert profile.apply_tuned_trainer({}, config) == {}


@pytest.mark.parametrize("key,value,where", [
    ("target_rescore_rate", 0.2, "--target-rescore-rate"),
    ("max_programs", 8, "--max-programs"),
    ("hbm_fraction", 0.5, "--hbm-fraction"),
    ("parity_probe", 64, "probe_size"),
])
def test_sweep_knobs_in_a_config_are_refused(key, value, where, tmp_path):
    """The sweep knobs are ``tune``'s flags: a build's config that changes
    one is refused, naming where it is set; at its default it passes."""
    from memvul_tpu_torch.config import TUNING_DEFAULTS, tuning_config

    assert tuning_config({"tuning": {key: TUNING_DEFAULTS[key]}})[key] == TUNING_DEFAULTS[key]
    config = {"tuning": {"profile_dir": str(tmp_path), "device_class": "cpu", key: value}}
    with pytest.raises(ValueError, match=where):
        profile.apply_tuned_trainer({}, config)


def test_unknown_device_refusal_and_no_cuda(capsys):
    from memvul_tpu_torch.__main__ import main
    from memvul_tpu_torch.telemetry.programs import PEAK_SPECS
    from memvul_tpu_torch.tuning.autotune import run_tune, unknown_device_refusal

    refusal = unknown_device_refusal("tpu_v9")
    assert refusal["error"] == "unknown_device_class" and refusal["known_markers"] == ["h100"]
    assert sorted(PEAK_SPECS) == ["h100"]
    rc = main(["tune", "--device-class", "tpu_v9", "--device", "cpu"])
    assert rc == 2
    assert json.loads(capsys.readouterr().out)["device_class"] == "tpu_v9"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_tune("all")


def test_tune_report_and_splice_through_the_cli(tmp_path, capsys):
    from memvul_tpu_torch.__main__ import main

    run = tmp_path / "run"
    run.mkdir()
    (run / "programs.json").write_text(json.dumps({"programs": SNAPSHOT, "roofline": ROOFLINE}))
    doc = tmp_path / "doc.md"
    doc.write_text("# Doc\n")
    assert main(["tune", "--report", str(run), "--splice", str(doc)]) == 0
    md = capsys.readouterr().out
    assert "`score:64x128`" in md and report.BEGIN_MARK in doc.read_text()
    assert main(["tune", "--report", str(tmp_path / "nothing")]) == 2


# -- the build reads the profile ------------------------------------------------


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    from memvul_tpu_torch.data.synthetic import build_workspace

    return build_workspace(tmp_path_factory.mktemp("tune_ws"), seed=5)


class _Captured(Exception):
    pass


def _captured_trainer_config(monkeypatch, config, tmp_path):
    from memvul_tpu_torch import build
    from memvul_tpu_torch.training import trainer as trainer_mod

    seen = {}

    class _Spy(trainer_mod.MemoryTrainer):
        def __init__(self, *args, config=None, **kw):
            seen["config"] = config
            raise _Captured

    monkeypatch.setattr(trainer_mod, "MemoryTrainer", _Spy)
    with pytest.raises(_Captured):
        build.train_from_config(config, tmp_path / "run", device="cpu")
    return seen["config"]


def test_train_from_config_reads_the_tuned_profile(ws, tmp_path, monkeypatch):
    from memvul_tpu_torch.data.synthetic import selfcheck_config

    monkeypatch.delenv("MEMVUL_TUNED_PROFILES", raising=False)
    base = selfcheck_config(ws)
    untouched = _captured_trainer_config(monkeypatch, dict(base), tmp_path)
    assert (untouched.train_buckets, untouched.dedup_anchors, untouched.prefetch_depth) \
        == ("pow2", True, 8)
    profile.save_profile(tmp_path / "profiles", "cpu", TUNED)
    tuned_cfg = dict(base, trainer=dict(base.get("trainer") or {}, dedup_anchors=True),
                     tuning={"profile_dir": str(tmp_path / "profiles")})
    tuned = _captured_trainer_config(monkeypatch, tuned_cfg, tmp_path)
    assert tuned.prefetch_depth == 16          # unset in the config: tuned
    assert tuned.dedup_anchors is True         # explicit: kept
    assert tuned.train_buckets == "pow2"


def test_serve_from_archive_reads_the_tuned_profile(ws, tmp_path, monkeypatch):
    from memvul_tpu_torch.archive import save_archive
    from memvul_tpu_torch.build import build_model, init_params, serve_from_archive
    from memvul_tpu_torch.models.convert import flax_from_params

    monkeypatch.delenv("MEMVUL_TUNED_PROFILES", raising=False)
    model_cfg = {"type": "model_memory", "encoder": {"preset": "tiny"}, "header_dim": 32}
    config = {"tokenizer": {"type": "wordpiece", "tokenizer_path": ws["paths"]["tokenizer"]},
              "dataset_reader": {"type": "reader_memory", "anchor_path": ws["paths"]["anchors"],
                                 "cve_path": ws["paths"]["cve"]},
              "model": model_cfg, "serving": {"max_length": 128, "max_batch": 8}}
    model = init_params(build_model(dict(model_cfg), ws["tokenizer"].vocab_size), seed=0)
    archive = save_archive(tmp_path / "model.tar.gz", config,
                           flax_from_params(model.state_dict(), model.config),
                           tokenizer_file=ws["paths"]["tokenizer"])
    profile.save_profile(tmp_path / "profiles", "cpu", TUNED)
    plain = serve_from_archive(archive, device="cpu")
    try:
        assert plain.predictor.score_impl == "bucketed" and plain.config.max_batch == 8
    finally:
        plain.drain()
    tuned = serve_from_archive(archive, device="cpu", overrides={
        "tuning": {"profile_dir": str(tmp_path / "profiles")}})
    try:
        assert tuned.predictor.score_impl == "ragged"       # unset: tuned
        assert tuned.predictor.token_budget == 2048
        assert tuned.config.max_batch == 8                   # explicit: kept
        assert tuned.predictor.cascade_band == (0.4, 0.6)
    finally:
        tuned.drain()
