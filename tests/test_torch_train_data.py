"""The port's offline pipeline, training pair streams and pair collation
against the JAX package's, on the same inputs and seeds: text
normalization, preprocessing, project splits and anchors equal; the
reader's pair streams equal instance for instance over epochs' reseeds;
pair batches equal array for array."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from memvul_tpu.data import batching as jbatching
from memvul_tpu.data import corpus as jcorpus
from memvul_tpu.data import cwe as jcwe
from memvul_tpu.data.normalize import normalize_text as jax_normalize
from memvul_tpu.data.readers import MemoryReader as JaxReader
from memvul_tpu.data.synthetic import build_workspace as jax_workspace
from memvul_tpu.data.synthetic import generate_corpus, research_view_records
from memvul_tpu.data.synthetic import selfcheck_config as jax_selfcheck
from memvul_tpu_torch.data import batching, corpus, cwe
from memvul_tpu_torch.data import synthetic as psynthetic
from memvul_tpu_torch.data.normalize import normalize_text
from memvul_tpu_torch.data.readers import MemoryReader
from memvul_tpu_torch.data.tokenizer import WordPieceTokenizer

GOLDEN = json.loads((Path(__file__).parent / "golden" / "normalizer_golden.json").read_text())
EXTRA_TEXTS = [
    "See https://cve.mitre.org/cgi-bin/cvename.cgi?name=CVE-2021-1234 and CWE-79.",
    "Crash in `foo.bar()` at src/main/java/Foo.java line 42 (v1.2.3-beta4) @alice",
    "```\nTraceback: ValueError: bad\n```\nplease see [docs](http://x.org/a.html)",
    None,
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return jax_workspace(tmp_path_factory.mktemp("tdata"), seed=5)


@pytest.mark.parametrize("index", range(0, len(GOLDEN), 4))
def test_normalize_text_matches_jax(index):
    for case in GOLDEN[index : index + 4]:
        assert normalize_text(case["input"]) == jax_normalize(case["input"])


@pytest.mark.parametrize("text", EXTRA_TEXTS)
def test_normalize_text_matches_jax_on_report_texts(text):
    assert normalize_text(text) == jax_normalize(text)


def _pipeline(lib_corpus, lib_cwe, seed):
    reports, cve_dict = generate_corpus(seed=seed, realistic_lengths=True, num_projects=6)
    clean = lib_corpus.preprocess(json.loads(json.dumps(reports)))
    train, test = lib_corpus.split_by_project(clean, held_out_frac=0.25, seed=seed)
    tree = lib_cwe.build_cwe_tree(research_view_records())
    positives = [dict(r, CWE_ID=cve_dict[r["CVE_ID"]]["CWE_ID"]) for r in train
                 if r["Security_Issue_Full"] == "1"]
    dist = lib_cwe.cwe_distribution(positives, cve_dict)
    anchors = lib_cwe.build_anchors(dist, tree, cve_dict, seed=seed)
    subtree = lib_cwe.bfs_subtree(tree, "79", level=2)
    return clean, train, test, dist, anchors, subtree, lib_cwe.describe_cwe(tree, "119")


@pytest.mark.parametrize("seed", [0, 3])
def test_preprocess_split_and_anchors_match_jax(seed):
    assert _pipeline(corpus, cwe, seed) == _pipeline(jcorpus, jcwe, seed)


def test_workspace_matches_jax(ws, tmp_path):
    mine = psynthetic.build_workspace(tmp_path / "port", seed=5)
    assert mine["anchors"] == ws["anchors"]
    assert mine["cve_dict"] == ws["cve_dict"]
    assert mine["splits"] == ws["splits"]
    for name in ("train", "validation", "test", "cve", "anchors"):
        assert Path(mine["paths"][name]).read_text() == Path(ws["paths"][name]).read_text()
    texts = list(ws["anchors"].values()) + [r["Issue_Body"] for r in ws["splits"]["test"]]
    assert mine["tokenizer"].vocab_size == ws["tokenizer"].vocab_size
    for text in texts:
        assert mine["tokenizer"].encode(text, max_length=128) == ws["tokenizer"].encode(
            text, max_length=128)
    assert psynthetic.selfcheck_config(mine)["trainer"] == jax_selfcheck(ws)["trainer"]


def _readers(ws, **kw):
    args = dict(cve_path=ws["paths"]["cve"], anchor_path=ws["paths"]["anchors"], **kw)
    return MemoryReader(**args), JaxReader(**args)


@pytest.mark.parametrize("kw", [
    dict(same_diff_ratio={"same": 2, "diff": 2}, sample_neg=0.5, seed=2021),
    dict(same_diff_ratio={"same": 16, "diff": 16}, sample_neg=0.01, seed=7, train_iter=2),
])
def test_train_pair_streams_match_jax_over_reseeds(ws, kw):
    port, ref = _readers(ws, **kw)
    for epoch_seed in (11, 12):
        port.reseed(epoch_seed)
        ref.reseed(epoch_seed)
        mine = list(port.read(ws["paths"]["train"], split="train"))
        want = list(ref.read(ws["paths"]["train"], split="train"))
        assert len(mine) > 0 and mine == want


def test_frozen_stream_and_eval_streams_match_jax(ws):
    port, ref = _readers(ws, seed=3, sample_neg=1.0)
    frozen = list(port.read(ws["paths"]["train"]))
    assert frozen == list(ref.read(ws["paths"]["train"]))
    # after the train split was grouped, a validation read of the same file
    # streams the cached groups, in both
    assert list(port.read(ws["paths"]["train"], split="validation")) == list(
        ref.read(ws["paths"]["train"], split="validation"))
    assert list(port.read(ws["paths"]["validation"])) == list(ref.read(ws["paths"]["validation"]))
    assert list(port.read(ws["paths"]["anchors"], split="golden")) == list(
        ref.read(ws["paths"]["anchors"], split="golden"))


def _assert_batches_equal(mine, want):
    assert len(mine) == len(want) > 0
    for a, b in zip(mine, want):
        assert sorted(a) == sorted(b)
        for key in a:
            if key == "meta":
                assert a[key] == b[key]
            elif isinstance(a[key], dict):
                for sub in a[key]:
                    np.testing.assert_array_equal(a[key][sub], b[key][sub])
            else:
                np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("buckets", ["pow2", (16, 64), None])
@pytest.mark.parametrize("dedup", [True, False])
def test_pair_batches_match_jax(ws, buckets, dedup):
    port, _ = _readers(ws, seed=5, sample_neg=0.5, same_diff_ratio={"same": 3, "diff": 3})
    instances = list(port.read(ws["paths"]["train"], split="train"))
    tok = ws["tokenizer"]
    mine_enc = batching.CachedEncoder(
        WordPieceTokenizer(tokenizer_path=ws["paths"]["tokenizer"]), max_length=64)
    want_enc = jbatching.CachedEncoder(tok, max_length=64)
    resolved = batching.resolve_train_buckets(buckets, 64)
    assert resolved == jbatching.resolve_train_buckets(buckets, 64)
    if resolved is None:
        mine = list(batching.batches_from_instances(instances, mine_enc, batch_size=8))
        want = list(jbatching.batches_from_instances(
            instances, want_enc, batch_size=8, pad_to_max=True))
    else:
        mine = list(batching.bucketed_pair_batches_from_instances(
            instances, mine_enc, batch_size=8, buckets=resolved, dedup_side2=dedup))
        want = list(jbatching.bucketed_pair_batches_from_instances(
            instances, want_enc, batch_size=8, buckets=resolved, dedup_side2=dedup))
        if dedup:
            assert all("sample2_index" in b for b in mine)
    _assert_batches_equal(mine, want)


def test_dedup_capacities_and_pow2_match_jax():
    for b in (1, 4, 8, 9, 32, 100):
        for floor in (8, 16):
            assert batching.dedup_capacities(b, floor) == jbatching.dedup_capacities(b, floor)
    for n in (48, 64, 256, 4096):
        assert batching.pow2_buckets(n) == jbatching.pow2_buckets(n)
    with pytest.raises(ValueError):
        batching.resolve_train_buckets([64], 256)
    with pytest.raises(ValueError):
        batching.resolve_train_buckets("auto", 256)


def test_prefetch_commits_on_the_worker_and_tracks_occupancy():
    import threading

    from memvul_tpu_torch.telemetry import Gauge

    main = threading.get_ident()
    seen = []

    def commit(x):
        seen.append(threading.get_ident())
        return x * 10

    gauge = Gauge()
    out = list(batching.prefetch(iter(range(6)), depth=2, commit=commit, occupancy=gauge))
    assert out == [0, 10, 20, 30, 40, 50]
    assert seen and all(t != main for t in seen)
    assert 0 <= gauge.value <= 2
