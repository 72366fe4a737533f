"""The span recorder (``telemetry/spans.py``) and the spans of the corpus
path: nesting and parents on two threads, the registry's per-thread phase,
batch ids shared by a batch's ``score.*`` and ``feed.collate`` spans, the
predictor's host seconds booked from the spans' own clock reads, and
nothing recorded, retained or written while recording is off."""

import json
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from memvul_tpu_torch import build
from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor
from memvul_tpu_torch.telemetry import Registry, spans

WORDS = [f"w{i}" for i in range(200)]


@pytest.fixture
def recording():
    spans.record(True)
    try:
        yield
    finally:
        spans.record(False)


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n")
    tokenizer = build.build_tokenizer({"type": "wordpiece", "vocab_path": str(path)})
    torch.manual_seed(0)
    model = build.build_model({"type": "model_memory", "encoder": {"preset": "tiny"},
                               "use_header": True, "header_dim": 16}, vocab_size=len(vocab))
    rng = np.random.default_rng(0)
    text = lambda n: " ".join(WORDS[int(i)] for i in rng.integers(0, len(WORDS), n))
    anchors = [{"text1": text(5), "meta": {"label": f"a{i}"}} for i in range(3)]
    instances = [{"text1": text(int(rng.integers(1, 30))), "label": "same", "meta": {"i": i}}
                 for i in range(120)]
    return model, tokenizer, anchors, instances


def _predictor(parts, telemetry=None):
    model, tokenizer, anchors, _ = parts
    predictor = SiamesePredictor(model, tokenizer, batch_size=8, max_length=32,
                                 buckets=[8, 16, 32], telemetry=telemetry)
    predictor.encode_anchors(anchors)
    predictor.warmup_compile()
    return predictor


def _mine(tids=None, names=None):
    return [s for s in spans.recorded()
            if (tids is None or s.tid in tids) and (names is None or s.name in names)]


def test_nesting_and_parents_on_two_threads_at_once(recording):
    both_open = threading.Barrier(2, timeout=10)
    tids = {}

    def work(tag, batch):
        tids[tag] = threading.get_native_id()
        with spans.span(f"{tag}.outer", batch):
            both_open.wait()
            t0 = spans.begin(f"{tag}.inner")
            both_open.wait()
            assert spans.end() >= t0
        with spans.span(f"{tag}.after"):
            pass

    threads = [threading.Thread(target=work, args=(tag, batch)) for tag, batch in (("a", 3), ("b", 7))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert tids["a"] != tids["b"]
    for tag, batch in (("a", 3), ("b", 7)):
        got = {s.name: s for s in _mine({tids[tag]})}
        outer, inner, after = got[f"{tag}.outer"], got[f"{tag}.inner"], got[f"{tag}.after"]
        assert outer.parent is None and outer.id == batch
        assert inner.parent == outer.seq and inner.id == batch  # the id passes inward
        assert after.parent is None and after.id is None
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
        assert after.start_ns >= outer.end_ns
    # the two outer spans were open at the same time
    a, b = _mine(names={"a.outer"})[0], _mine(names={"b.outer"})[0]
    assert a.start_ns < b.end_ns and b.start_ns < a.end_ns


def test_a_span_across_a_restart_of_the_recording_is_left_out():
    spans.record(True)
    try:
        t = spans.begin("straddles")
        spans.record(True)  # a fresh recording: the open span is not in it
        with spans.span("fresh"):
            pass
        assert spans.end() >= t
        names = [s.name for s in _mine({threading.get_native_id()})]
        assert names == ["fresh"] and _mine(names={"fresh"})[0].parent is None
    finally:
        spans.record(False)


def test_the_phase_is_per_thread():
    """Thread a opens "a", thread b opens "b", a closes first.  One stack
    shared by every thread showed a the phase "b", and closing "a" then
    found "b" on top: the phase stayed "a" after both had closed."""
    tel = Registry()
    a_open, both_open, main_read, a_closed = (threading.Event() for _ in range(4))
    seen = {}

    def a():
        with tel.span("a"):
            a_open.set()
            both_open.wait(10)
            seen["a"] = tel.phase
            main_read.wait(10)
        a_closed.set()

    def b():
        a_open.wait(10)
        with tel.span("b"):
            both_open.set()
            a_closed.wait(10)
            seen["b"] = tel.phase

    threads = [threading.Thread(target=f) for f in (a, b)]
    for t in threads:
        t.start()
    both_open.wait(10)
    seen["main, both open"] = tel.phase  # no span of its own: the one opened last
    main_read.set()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert seen == {"a": "a", "b": "b", "main, both open": "b"}
    assert tel.phase == "idle"


def test_nothing_is_recorded_or_retained_while_recording_is_off():
    spans.record(False)
    before = len(spans.recorded())
    assert spans.span("score.launch", 1) is spans.span("feed.collate")  # one shared scope

    def open_and_close(n):
        for i in range(n):
            with spans.span("score.book", i):
                pass
            spans.begin("score.sync", i)
            spans.end()

    open_and_close(100)  # warm
    tracemalloc.start()
    try:
        snap0 = tracemalloc.take_snapshot()
        open_and_close(20000)
        snap1 = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    source = [tracemalloc.Filter(True, spans.__file__)]
    grown = [d for d in snap1.filter_traces(source).compare_to(snap0.filter_traces(source), "lineno")
             if d.size_diff > 0]
    assert grown == []
    assert len(spans.recorded()) == before and spans.dropped() == 0


def test_a_batchs_spans_share_its_id_and_the_stats_are_the_spans(parts, recording, tmp_path):
    tel = Registry(run_dir=tmp_path / "run")
    predictor = _predictor(parts, telemetry=tel)
    out = list(predictor.score_instances(iter(parts[3])))
    tel.close()
    score = _mine(names={"score.feed_wait", "score.launch", "score.h2d", "score.sync", "score.book"})
    launch_tid = {s.tid for s in score}
    assert len(launch_tid) == 1
    feed = _mine(names={"feed.tokenize", "feed.collate", "feed.put_wait"})
    assert feed and not {s.tid for s in feed} & launch_tid
    n = len(out)
    by_name = {}
    for s in score + feed:
        by_name.setdefault(s.name, []).append(s)
    # the warm-up's copies are children of its warmup.shape spans
    launches = {s.seq: s for s in by_name["score.launch"]}
    by_name["score.h2d"] = [s for s in by_name["score.h2d"] if s.parent in launches]
    for name in ("score.launch", "score.h2d", "score.sync", "score.book", "feed.collate",
                 "feed.put_wait"):
        assert sorted(s.id for s in by_name[name]) == list(range(n)), name
    # one more wait than batches: the one that found the stream's end
    assert sorted(s.id for s in by_name["score.feed_wait"]) == list(range(n + 1))
    assert [s.id for s in by_name["feed.tokenize"]] == [0]  # 120 instances: one block of 512
    for h2d in by_name["score.h2d"]:
        assert launches[h2d.parent].id == h2d.id
    # each batch's answers came back in the order its spans say
    sync = sorted(by_name["score.sync"], key=lambda s: s.start_ns)
    assert [s.id for s in sync] == list(range(n))
    # the feed collated batch i before the predictor launched it
    collate = {s.id: s for s in by_name["feed.collate"]}
    for s in by_name["score.launch"]:
        assert collate[s.id].end_ns <= s.start_ns
    stats = predictor.stats
    for key, name in (("feed_wait_s", "score.feed_wait"), ("launch_s", "score.launch"),
                      ("sync_s", "score.sync")):
        assert stats[key] == sum(s.end_ns - s.start_ns for s in by_name[name]) / 1e9, key
    # the padding ledger: every drained batch's live and padded token slots
    counters = tel.snapshot()["counters"]
    assert counters["score.tokens_real"] == sum(
        len(predictor.encoder.encode_many([inst["text1"]])[0]) for inst in parts[3])
    assert counters["score.tokens_padded"] == sum(
        length * slots for length, slots in predictor.stats["bucket_row_slots"].items())
    # the events file has set-up spans and no line a batch
    kinds = [json.loads(line) for line in (tmp_path / "run" / "events.jsonl").read_text().splitlines()]
    named = [e.get("name") for e in kinds if e["kind"] in ("span", "span_start")]
    assert set(named) == {"anchor_encode", "aot_warmup"}
    assert not any(str(e.get("name", "")).startswith(("score.", "feed.")) for e in kinds)


def test_set_up_spans_nest_under_the_registry_spans(parts, recording):
    predictor = _predictor(parts)
    mine = _mine({threading.get_native_id()})
    top = {s.name: s for s in mine if s.parent is None}
    assert {"anchor_encode", "aot_warmup"} <= set(top)
    shapes = [s for s in mine if s.name == "warmup.shape"]
    assert [s.id for s in shapes] == [length for _, length in predictor.stream_shapes()]
    assert {s.parent for s in shapes} == {top["aot_warmup"].seq}
    # each warmed shape copies its block once
    h2d = [s for s in mine if s.name == "score.h2d"]
    assert sorted(s.parent for s in h2d) == sorted(s.seq for s in shapes)
    # the registry's spans keep their histograms
    hist = predictor.telemetry.snapshot()["histograms"]
    assert hist["span.aot_warmup"]["count"] == 1.0
    assert hist["span.aot_warmup"]["total"] == pytest.approx(
        (top["aot_warmup"].end_ns - top["aot_warmup"].start_ns) / 1e9)


def test_the_stats_hold_without_recording(parts):
    spans.record(False)
    predictor = _predictor(parts)
    out = list(predictor.score_instances(iter(parts[3])))
    assert sum(len(metas) for _, metas in out) == len(parts[3])
    stats = predictor.stats
    assert stats["batches"] == len(out)
    assert all(isinstance(stats[k], float) and stats[k] > 0 for k in ("launch_s", "sync_s"))
    assert stats["feed_wait_s"] >= 0.0
