"""The general traffic generator: seeded, distinct, and true to its laws."""

import numpy as np
import pytest

from benchmark.lib import manifest, traffic
from benchmark.reference.wordpiece import WordPiece

SENTENCES = manifest.traffic("corpus-long")["sentences"]


@pytest.fixture(scope="module")
def vocab():
    return traffic.build_vocab(30522, 30522)


@pytest.fixture(scope="module")
def pool(vocab):
    return traffic.sentence_pool(vocab, SENTENCES, 7, WordPiece(vocab))


@pytest.fixture(scope="module")
def pools(vocab, pool):
    realistic = manifest.traffic("corpus-realistic")["sentences"]
    return {"corpus-long": pool,
            "corpus-realistic": traffic.sentence_pool(vocab, realistic, 7, WordPiece(vocab))}


def test_vocab_is_bert_shaped(vocab):
    assert len(vocab) == len(set(vocab)) == 30522
    assert (vocab[0], vocab[100], vocab[101], vocab[102], vocab[103]) == \
        ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
    assert traffic.build_vocab(30522, 30522) == vocab
    assert traffic.build_vocab(30522, 1) != vocab
    assert sum(t.startswith("##") for t in vocab) > 4000


def test_corpus_is_seeded_and_distinct(vocab, pool):
    mix = manifest.traffic("corpus-realistic")
    a, la = traffic.corpus(mix, 3000, pool, vocab, 11)
    b, lb = traffic.corpus(mix, 3000, pool, vocab, 11)
    c, _ = traffic.corpus(mix, 3000, pool, vocab, 12)
    assert a == b and (la == lb).all() and a != c
    assert len(set(a)) == len(a)
    assert traffic.sentence_pool(vocab, SENTENCES, 7, WordPiece(vocab))["texts"].tolist() == \
        pool["texts"].tolist()


@pytest.mark.parametrize("mix", ["corpus-realistic", "corpus-long"])
def test_piece_counts_are_the_tokenizers(vocab, pools, mix):
    texts, pieces = traffic.corpus(manifest.traffic(mix), 200, pools[mix], vocab, 5)
    wp = WordPiece(vocab)
    assert [len(wp.encode(t)) for t in texts] == pieces.tolist()


def test_realistic_law(vocab, pools):
    """lognormal(4.6, 1.0) words, sentences added until the count is
    reached, at the wordpieces measured for the program's synthetic reports:
    mean 150 and median 106 at the 512 cap, p90 358, 4.7% at the cap, bucket
    shares 0.30 / 0.28 / 0.25 / 0.18."""
    texts, pieces = traffic.corpus(manifest.traffic("corpus-realistic"), 6400,
                                   pools["corpus-realistic"], vocab, 3)
    words = np.array([len(t.split()) for t in texts])
    assert 95 <= np.median(words) <= 115
    capped = np.minimum(pieces, 512)
    assert 100 <= np.median(capped) <= 112 and 142 <= capped.mean() <= 160
    assert 340 <= np.percentile(capped, 90) <= 385
    assert 0.035 <= (pieces >= 512).mean() <= 0.065
    shares = np.bincount(np.searchsorted([64, 128, 256, 512], capped), minlength=4) / capped.size
    np.testing.assert_allclose(shares, [0.30, 0.28, 0.25, 0.18], atol=0.025)


@pytest.mark.parametrize("mix", ["corpus-realistic", "corpus-long"])
def test_corpus_is_made_as_it_is_read(vocab, pools, mix):
    """A chunk at a time, each report the same however far a run reads."""
    law = manifest.traffic(mix)
    c = traffic.Corpus(law, pools[mix], vocab, 8)
    assert c.text(0) and len(c) == traffic.CHUNK
    far = c.text(2 * traffic.CHUNK + 5)
    assert len(c) == 3 * traffic.CHUNK == c.pieces().size
    texts, pieces = traffic.corpus(law, 3 * traffic.CHUNK, pools[mix], vocab, 8)
    assert texts == c.texts and (pieces == c.pieces()).all() and texts[2 * traffic.CHUNK + 5] == far
    assert len(set(texts)) == len(texts)


def test_long_law(vocab, pool):
    _, pieces = traffic.corpus(manifest.traffic("corpus-long"), 3200, pool, vocab, 3)
    assert pieces.min() >= 513
    thirds = [(pieces <= 1024).mean(), ((pieces > 1024) & (pieces <= 2048)).mean(), (pieces > 2048).mean()]
    assert all(abs(t - 1 / 3) < 0.03 for t in thirds), thirds


def test_lengths_are_stratified():
    u = traffic.stratified_uniforms(traffic.STRATA * 5, np.random.default_rng(0))
    for block in u.reshape(5, traffic.STRATA):
        assert sorted(np.floor(block * traffic.STRATA).astype(int)) == list(range(traffic.STRATA))


def test_reference_wordpiece_is_the_programs(vocab, pool, tmp_path):
    from memvul_tpu_torch.data.tokenizer import WordPieceTokenizer

    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    program = WordPieceTokenizer(vocab_path=tmp_path / "vocab.txt")
    ours = WordPiece(vocab)
    texts, _ = traffic.corpus(manifest.traffic("corpus-realistic"), 300, pool, vocab, 9)
    texts += ["Tab\there, new\nline; x" * 3, "a" * 120 + " word", "qzqzqzqzq!!", ""]
    for cap in (None, 64):
        assert [program.encode(t, max_length=cap) for t in texts] == \
            [ours.encode(t, max_length=cap) for t in texts]


def test_anchors(vocab, pool):
    spec = manifest.config("memvul-base")["anchors"]
    a = traffic.anchors(spec, pool, vocab, 4)
    assert len(a) == 129 and len({x["meta"]["label"] for x in a}) == 129
    assert a == traffic.anchors(spec, pool, vocab, 4)


def test_arrivals():
    a = traffic.arrival_offsets("poisson", 2000, 100.0, 1)
    assert a == traffic.arrival_offsets("poisson", 2000, 100.0, 1)
    assert abs(a[-1] / 2000 - 0.01) < 0.001
    assert traffic.arrival_offsets("burst", 5, 1.0, 1, burst_size=2, burst_idle_s=0.5) == \
        [0.0, 0.0, 0.5, 0.5, 1.0]
